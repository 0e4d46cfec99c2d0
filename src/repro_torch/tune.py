"""Run or resume a named autotuning session from the command line.

    python -m repro_torch.tune --session nightly --benchmark triad --full
    python -m repro_torch.tune --session nightly --benchmark dgemm --full \\
        --strategy random --budget 16 --seed 0
    python -m repro_torch.tune --session nightly --benchmark gemm_tiled \\
        --report
    python -m repro_torch.tune --session smoke --benchmark synthetic \\
        --device cpu
    python -m repro_torch.tune --session adaptive --benchmark gemm_tiled \\
        --strategy surrogate --budget 8 --seed 0 --history
    python -m repro_torch.tune --compact-history 20

(with ``src`` on ``PYTHONPATH``). Trials persist to
``<cache-dir>/<session>.jsonl`` keyed by (benchmark, config, hardware
fingerprint), in the JAX package's format; re-running the same session
skips every completed config and warm-starts the incumbent from the best
cached trial, so a killed run resumes exactly where it stopped.
``--fresh`` discards the session's cache first. ``--strategy`` picks the
search policy (exhaustive, halving, random, neighborhood, or the
model-guided surrogate/bandit), ``--budget`` caps
random/neighborhood/surrogate/bandit proposals, ``--acquisition`` picks
the surrogate's scoring rule, and ``--transfer-from SESSION[:BENCHMARK]``
seeds the search with another session's cached incumbents.
``--backend`` runs the trials serially, on threads, in spawned worker
processes (``process:N``) or on a simulated fleet of N workers
(``simulated:N``); ``--trace`` records a span trace of the session.
``--report`` renders the cache-backed roofline from the session's
``dgemm`` and ``triad`` trials. A quick ``dgemm`` session on the card
tunes the card-sized space (``bench.common.card_dgemm_space``).

Every completed run also appends its incumbent to the performance-history
ledger (``<cache-dir>/history.jsonl``, the JAX package's format);
``--history`` prints the series' trend (sparkline + per-run CIs) and
regression verdict afterwards (see ``python -m repro_torch.perf_gate``).
``--compact-history N`` compacts that ledger (keep each series' best run
plus its N most recent, drop older superseded runs); it also works
standalone, without ``--session``, and then touches no device.

``--validate`` gates the pre-run workload audit (``repro_torch.lint``
pass 1: the benchmark's declared work term against one traced call of
its kernel, before any trial runs): ``warn`` (the default) warns and
tunes, ``strict`` aborts on a mis-declared workload, ``off`` skips it.
``--live`` prints a one-line status to stderr after every trial: trials
done/pruned/cached (``obs.metrics``) and executable-cache hits/compiles.

Everything runs on the card (``--device cuda``, the default) unless
``--device cpu`` is given; the footer's ``kernels`` line counts the
hand-written kernels' launches in this run.

    python -m repro_torch.tune --session s --benchmark triad \
        --validate strict --live --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

STRATEGIES = ("exhaustive", "halving", "random", "neighborhood",
              "surrogate", "bandit")
BENCHMARKS = ("dgemm", "triad", "gemm_tiled", "synthetic")


def parse_backend(spec: str):
    """'serial', 'thread:N', 'process:N', or 'simulated:N'."""
    from .core import (ProcessPoolBackend, SerialBackend,
                       SimulatedShardedBackend, ThreadPoolBackend)
    kind, _, arg = spec.partition(":")
    n = int(arg) if arg else 4
    if kind == "serial":
        return SerialBackend()
    if kind == "thread":
        return ThreadPoolBackend(n)
    if kind == "process":
        return ProcessPoolBackend(n)
    if kind == "simulated":
        return SimulatedShardedBackend(n)
    raise argparse.ArgumentTypeError(
        f"unknown backend {spec!r} "
        "(serial | thread[:N] | process[:N] | simulated[:N])")


def make_strategy(args):
    """Build the SearchStrategy the CLI flags describe (None — let the
    Tuner default to the exhaustive strategy honoring --order/--seed)."""
    from .core import (NeighborhoodStrategy, RandomSearchStrategy,
                       SuccessiveHalvingStrategy)
    if args.strategy == "exhaustive":
        return None
    if args.strategy == "halving":
        return SuccessiveHalvingStrategy()
    if args.strategy == "random":
        return RandomSearchStrategy(budget=args.budget, seed=args.seed)
    if args.strategy == "surrogate":
        from .surrogate import SurrogateStrategy
        return SurrogateStrategy(budget=args.budget, seed=args.seed,
                                 acquisition=args.acquisition)
    if args.strategy == "bandit":
        from .surrogate import BanditStrategy
        return BanditStrategy(budget=args.budget, seed=args.seed)
    return NeighborhoodStrategy(budget=args.budget)


def compact_history(args) -> int:
    """Apply ``RunLedger.compact`` to the cache dir's shared ledger."""
    from .history import RunLedger
    path = pathlib.Path(args.cache_dir) / "history.jsonl"
    if not path.exists():
        print(f"compact    : no ledger at {path} — nothing to do")
        return 0
    ledger = RunLedger(path)
    n_before = len(ledger)
    dropped = ledger.compact(keep_last=args.compact_history)
    print(f"compact    : {path} — dropped {dropped} of {n_before} run(s), "
          f"kept {len(ledger)}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--session", default=None,
                    help="session name; trials persist under this name "
                         "(required unless only --compact-history is asked)")
    ap.add_argument("--benchmark", default="dgemm", choices=BENCHMARKS,
                    help="'gemm_tiled' tunes the hand-written GEMM's tile "
                         "at 4096x2048x6144 f32; 'synthetic' is an "
                         "instant quadratic objective for smoke-testing "
                         "sessions without timing noise")
    ap.add_argument("--backend", type=parse_backend, default=None,
                    metavar="SPEC",
                    help="serial | thread[:N] | process[:N] | simulated[:N]")
    ap.add_argument("--strategy", default="exhaustive", choices=STRATEGIES,
                    help="search strategy")
    ap.add_argument("--budget", type=int, default=None,
                    help="max proposals for --strategy random/neighborhood/"
                         "surrogate/bandit")
    ap.add_argument("--acquisition", default="ei", choices=("ei", "ucb"),
                    help="acquisition rule for --strategy surrogate: "
                         "expected improvement against the incumbent's CI "
                         "bound, or UCB at the settings' confidence level")
    ap.add_argument("--transfer-from", default=None, metavar="SESSION[:BENCH]",
                    help="seed the search with another session's cached "
                         "incumbents (default: same benchmark name)")
    ap.add_argument("--order", default="exhaustive",
                    choices=("exhaustive", "reverse", "random"),
                    help="visit order for --strategy exhaustive")
    ap.add_argument("--seed", type=int, default=None,
                    help="shuffle seed for --order/--strategy random")
    ap.add_argument("--full", action="store_true",
                    help="paper Table I budgets and spaces instead of "
                         "quick ones")
    ap.add_argument("--cache-dir", default=".tuning_sessions")
    ap.add_argument("--no-warm-start", action="store_true",
                    help="do not seed the incumbent from cached trials")
    ap.add_argument("--validate", default="warn",
                    choices=("off", "warn", "strict"),
                    help="pre-run workload audit (repro_torch.lint pass 1): "
                         "cross-check the benchmark's declared work term "
                         "against the traced kernel cost before any trial "
                         "runs; 'strict' aborts on a mismatch")
    ap.add_argument("--fresh", action="store_true",
                    help="discard this session's cached trials first")
    ap.add_argument("--trace", nargs="?", const=True, default=False,
                    metavar="PATH",
                    help="record a span trace of the whole session "
                         "(default path <cache-dir>/<session>.trace.jsonl)")
    ap.add_argument("--live", action="store_true",
                    help="print a live one-line campaign status to stderr "
                         "(trials done/pruned/cached, exec-cache hits)")
    ap.add_argument("--report", action="store_true",
                    help="after tuning, render the cache-backed roofline "
                         "dashboard from this session's trial cache")
    ap.add_argument("--history", action="store_true",
                    help="after tuning, print this series' run-ledger "
                         "trend (sparkline + per-run CIs) and its "
                         "regression verdict")
    ap.add_argument("--compact-history", type=int, default=None, metavar="N",
                    help="compact <cache-dir>/history.jsonl: keep each "
                         "series' best run plus its N most recent, drop "
                         "older superseded runs; runs after tuning, or "
                         "standalone when --session is omitted")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every benchmark runs (default: cuda; "
                         "raises when no card is visible)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.session is None:
        if args.compact_history is None:
            ap.error("--session is required (unless only compacting: "
                     "--compact-history N)")
        return compact_history(args)

    from . import kernels
    from .bench.common import (block_smem_limit, dgemm_benchmark,
                               gemm_tiled_benchmark, paper_dgemm_space,
                               gemm_tiled_space, paper_settings,
                               synthetic_benchmark, triad_benchmark,
                               triad_sizes)
    from .core import TrialCache, Tuner, TuningSession, grid
    from .core import hardware_fingerprint
    from .device import resolve_device

    device = resolve_device(args.device).type
    quick = not args.full
    settings = dataclasses.replace(paper_settings(quick),
                                   use_ci_convergence=True,
                                   use_inner_prune=True,
                                   use_outer_prune=True)
    if args.benchmark == "dgemm":
        space = paper_dgemm_space(quick, device)
        benchmark = dgemm_benchmark(device)
    elif args.benchmark == "gemm_tiled":
        space = gemm_tiled_space(smem_limit=block_smem_limit(device))
        benchmark = gemm_tiled_benchmark(device)
    elif args.benchmark == "synthetic":
        space = grid(x=tuple(range(12)))
        benchmark = synthetic_benchmark
    else:
        space = grid(n_bytes=triad_sizes(quick))
        benchmark = triad_benchmark(device)
        # Each TRIAD size probes a different memory subsystem: the sizes
        # are measurements, not competitors. Pruning a slow DRAM stream
        # against the cache-resident incumbent would cache a truncated
        # bandwidth estimate and drop that subsystem from --report.
        settings = dataclasses.replace(settings, use_inner_prune=False,
                                       use_outer_prune=False)

    fingerprint = hardware_fingerprint(device)
    cache_path = pathlib.Path(args.cache_dir) / f"{args.session}.jsonl"
    if args.fresh and cache_path.exists():
        cache_path.unlink()

    strategy = make_strategy(args)
    if strategy is None:
        tuner = Tuner(space, settings, order=args.order, seed=args.seed)
    else:
        tuner = Tuner(space, settings, strategy=strategy)
    session = TuningSession(args.session, tuner, benchmark,
                            cache_dir=args.cache_dir,
                            warm_start=not args.no_warm_start,
                            fingerprint=fingerprint,
                            benchmark_name=args.benchmark,
                            trace=args.trace)

    seeds = []
    if args.transfer_from is not None:
        source, _, source_bench = args.transfer_from.partition(":")
        source_bench = source_bench or args.benchmark
        source_path = pathlib.Path(args.cache_dir) / f"{source}.jsonl"
        if source_path.exists():
            donor = TrialCache(source_path, fingerprint=fingerprint)
            seeds = donor.suggest_seeds(source_bench,
                                        direction=settings.direction)
        print(f"transfer   : {len(seeds)} seed(s) from session "
              f"{source!r} (benchmark {source_bench!r})")

    print(f"session    : {args.session}  ({cache_path})")
    print(f"fingerprint: {fingerprint}")
    print(f"strategy   : {args.strategy}"
          + (f" (order={args.order})" if args.strategy == "exhaustive" else "")
          + (f" (acquisition={args.acquisition})"
             if args.strategy == "surrogate" else "")
          + (f" (budget={args.budget})" if args.budget is not None else ""))
    print(f"space      : {space!r}  ({space.cardinality} configs)")
    print(f"cached     : {len(session.cache)} trials "
          f"({session.cache.n_stale} stale skipped)")

    done = 0
    if args.live:
        from .core import default_cache
        from .obs.metrics import metrics as obs_metrics
        live_base = obs_metrics().snapshot()
        exec_base = default_cache().stats

    def live_status():
        c = obs_metrics().delta(live_base).get("counters", {})
        x = default_cache().stats.delta(exec_base)
        line = (f"trials {c.get('trials.completed', 0)} "
                f"(pruned {c.get('trials.pruned', 0)}, "
                f"cached {c.get('trials.cached', 0)}) | "
                f"exec-cache hits {x.hits} compiles {x.compiles}")
        print(f"\r[live] {line}   ", end="", file=sys.stderr, flush=True)

    def progress(cfg, res):
        nonlocal done
        done += 1
        tag = "PRUNED" if res.pruned else f"{res.score:10.2f}"
        print(f"  [{done:4d}/{space.cardinality}] {cfg} -> {tag} "
              f"({res.stop_reason})", flush=True)
        if args.live:
            live_status()

    kernels.reset_launch_counts()
    result = session.run(backend=args.backend, progress=progress,
                         seeds=seeds, timestamp=time.time(),
                         validate=args.validate)
    if args.live:
        print(file=sys.stderr)   # terminate the \r status line
    launches = kernels.launch_counts()
    print(f"\nbest      : {result.best_config}  score={result.best_score}")
    print(f"trials    : {len(result.trials)}  cached={result.n_cached}  "
          f"pruned={result.n_pruned}  samples={result.total_samples}")
    print(f"strategy  : {result.strategy}  rounds={len(result.batches)}  "
          f"seeded={result.n_seeded}")
    print(f"backend   : {result.backend}  workers={result.n_workers}  "
          f"wall={result.parallel_time_s:.2f}s "
          f"(serial-equivalent {result.serial_time_s:.2f}s)")
    if result.improvements:
        trail = " -> ".join(f"{score:.2f}"
                            for _, score in result.improvements)
        print(f"incumbent : {trail}")
    if result.trace_path:
        print(f"trace     : {result.trace_path}")
    print("kernels   : " + "  ".join(f"{name}={n}"
                                     for name, n in sorted(launches.items()))
          + " launches")

    if args.history:
        from .history import detect_regressions, render_trend_text
        runs = session.ledger.series(args.benchmark, fingerprint)
        print()
        print(render_trend_text(runs))
        report = detect_regressions(session.ledger,
                                    benchmark=args.benchmark,
                                    fingerprint=fingerprint)
        print(report.render_text(), end="")

    if args.report:
        from .core import build_reports, load_trials, render_markdown
        reports, skipped = build_reports(load_trials(cache_path))
        if reports:
            print()
            print(render_markdown(reports, skipped))
        else:
            print("\n[report] nothing to render: the cache needs unpruned "
                  "'dgemm' and 'triad' trials (run both benchmarks under "
                  "this session name).")
            for fp, reason in skipped:
                print(f"[report]   {fp}: {reason}")

    if args.compact_history is not None:
        compact_history(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
