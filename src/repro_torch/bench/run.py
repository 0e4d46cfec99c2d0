"""Benchmark harness entry point — one module per paper table/figure.

Prints ``name,us_per_call,derived`` CSV rows (via ``common.emit``) plus the
human-readable tables. ``--full`` uses the paper's Table I budgets (slow);
the default quick mode preserves every comparison's structure at CI-scale
budgets. Everything runs on the card unless ``--device cpu`` is given.

    python -m repro_torch.bench.run [--full] [--only <name>] [--device cpu]
        [--resume DIR [--report] [--html PATH]]

``--html`` writes the self-contained HTML dashboard (rooflines, and the
run ledger's trends and regression verdicts when ``DIR/history.jsonl``
exists) from the ``--resume`` cache dir.

"""

from __future__ import annotations

import argparse
import inspect
import sys
import time

from . import (distributed_tuner, iteration_counts, kernel_autotune,
               matmul_peak, optimizations, roofline_model, size_sweep, triad)
from .common import emit

BENCHES = {
    "matmul_peak": matmul_peak.run,                # Tables IV/V
    "triad": triad.run,                            # Table VI
    "iteration_counts": iteration_counts.run,      # Table VII
    "optimizations": optimizations.run,            # Tables VIII-XI (headline)
    "size_sweep": size_sweep.run,                  # Fig. 6
    "roofline_model": roofline_model.run,          # Fig. 1
    "kernel_autotune": kernel_autotune.run,        # beyond-paper
    # beyond-paper: execution backends + search-strategy comparison
    "distributed_tuner": distributed_tuner.run,
}


def run_benches(names, *, quick: bool = True, device: str = "cuda",
                resume=None) -> dict:
    """Run the named benches in order; returns each bench's result.
    ``resume`` is the cache directory of the cache-aware benches."""
    results = {}
    for name in names:
        fn = BENCHES[name]
        params = inspect.signature(fn).parameters
        kwargs = {"quick": quick}
        if "device" in params:
            kwargs["device"] = device
        # cache-aware benches opt in by taking a cache_dir kwarg
        if resume is not None and "cache_dir" in params:
            kwargs["cache_dir"] = resume
        t0 = time.perf_counter()
        try:
            results[name] = fn(**kwargs)
            emit(f"{name}/total", (time.perf_counter() - t0) * 1e6, "ok")
        except Exception as e:  # noqa: BLE001
            emit(f"{name}/total", (time.perf_counter() - t0) * 1e6,
                 f"FAIL:{type(e).__name__}")
            print(f"[benchmarks] {name} failed: {e}", file=sys.stderr)
            raise
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.run",
                                 description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="paper Table I budgets (minutes -> ~1h)")
    ap.add_argument("--only", default=None, choices=list(BENCHES))
    ap.add_argument("--resume", nargs="?", const=".tuning_sessions",
                    default=None, metavar="DIR",
                    help="persist tuning trials under DIR (default "
                         ".tuning_sessions) and skip configs already "
                         "evaluated by a previous --resume run")
    ap.add_argument("--report", action="store_true",
                    help="after the benches, render the cache-backed "
                         "roofline dashboard from the --resume cache dir")
    ap.add_argument("--html", default=None, metavar="PATH",
                    help="after the benches, write a self-contained HTML "
                         "dashboard (rooflines + run-ledger trends and "
                         "regression verdicts) from the --resume cache dir")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every bench runs (default: cuda; raises "
                         "when no card is visible)")
    args = ap.parse_args(argv)

    print("name,us_per_call,derived")
    names = [args.only] if args.only else list(BENCHES)
    run_benches(names, quick=not args.full, device=args.device,
                resume=args.resume)

    if args.report or args.html:
        import pathlib

        from ..core import build_reports, load_trials, render_markdown

        cache_dir = pathlib.Path(args.resume or ".tuning_sessions")
        trials = load_trials(cache_dir) if cache_dir.is_dir() else []
        reports, skipped = build_reports(trials)
        if args.report:
            if reports:
                print()
                print(render_markdown(reports, skipped))
            elif skipped:
                print(f"\n[report] no reportable fingerprint under "
                      f"{cache_dir}/:", file=sys.stderr)
                for fp, reason in skipped:
                    print(f"[report]   {fp}: {reason}", file=sys.stderr)
            else:
                print(f"\n[report] no cached trials under {cache_dir}/ — "
                      "run with --resume so roofline_model persists its "
                      "dgemm/triad sessions first.", file=sys.stderr)
        if args.html:
            from ..history import RunLedger, write_dashboard

            ledger_path = cache_dir / "history.jsonl"
            ledger = RunLedger(ledger_path) if ledger_path.exists() else None
            stamp = time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime())
            write_dashboard(args.html, reports, skipped, ledger=ledger,
                            title="Benchmark dashboard",
                            subtitle=f"generated {stamp} from "
                                     f"{cache_dir}/")
            print(f"[report] wrote {args.html}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
