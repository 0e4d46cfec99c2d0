"""Run a shape-sweep campaign and query its dispatch-time config oracle.

    python -m repro_torch.sweep --session sweep-demo \\
        --benchmark synthetic --budget-per-shape 9 --device cpu
    python -m repro_torch.sweep --session sweep-demo \\
        --benchmark synthetic --predict m=768,n=640 --device cpu
    python -m repro_torch.sweep --session sweep-eval --benchmark dgemm \\
        --grid "m=1024,2048,4096;n=1024,2048,4096;k=1024" \\
        --budget-per-shape 3 --oracle-eval m=2048,n=2048,k=1024

(with ``src`` on ``PYTHONPATH``). A campaign tunes every shape of a grid
(``--grid "m=256,512;n=256,512"``, default: the quick 3×3 GEMM grid)
through one resumable session cache; each shape's surrogate is warmed
with the cached trials of its siblings, so ``--budget-per-shape`` can sit
far below the config-space cardinality. ``--predict SHAPE`` then asks the
oracle for the best config of an arbitrary — typically untuned — shape.
``--oracle-eval SHAPE`` is the holdout protocol: the shape is *excluded*
from the campaign, the oracle predicts its config, and an exhaustive
ground-truth pass over that shape (not cached — ground truth must not
leak into the oracle) reports the prediction's gap to the true optimum
and the trial savings. Shapes use the ``name=value`` key format of
``repro_torch.sweep.shapes`` throughout.

The flags and printed lines are those of the JAX package's
``scripts/sweep.py``, with ``--device``. ``--validate`` gates each
shape's pre-run workload audit (``repro_torch.lint`` pass 1: ``warn``,
the default, ``strict`` or ``off``). One difference: where the predicted
config was pruned in the ground-truth pass, the JAX CLI reports no gap;
this one measures that config once more, alone and unpruned, and reports
the gap against the pass's optimum. Everything runs on the card
(``cuda``, the default; it raises without one) unless ``--device cpu``
is given. ``dgemm`` measures the chunked f32 product
(``bench.common.chunked_dgemm_family``) on that device.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import pathlib
import time

from ..core import SearchSpace, TrialCache, Tuner, hardware_fingerprint, param
from ..core.cache import config_key
from ..tune import parse_backend
from . import SweepCampaign, parse_shape_key, shape_key


def parse_grid(spec: str) -> SearchSpace:
    """'m=256,512,1024;n=256,512' → the shape grid SearchSpace."""
    params = []
    for part in spec.split(";"):
        name, sep, raw = part.partition("=")
        if not sep or not name or not raw:
            raise argparse.ArgumentTypeError(f"malformed grid {spec!r}")
        values = tuple(parse_shape_key(f"v={v}")["v"]
                       for v in raw.split(","))
        params.append(param(name.strip(), values))
    return SearchSpace(params)


def parse_shape(spec: str) -> dict:
    try:
        return parse_shape_key(spec)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--session", required=True,
                    help="campaign name: trials persist under "
                         "<cache-dir>/<session>.jsonl, per-shape "
                         "benchmarks as '<session>@<shape_key>'")
    ap.add_argument("--benchmark", default="synthetic",
                    choices=("synthetic", "dgemm"),
                    help="'synthetic' is the instant shape-conditioned "
                         "objective; 'dgemm' measures the chunked matmul "
                         "family (GFLOP/s)")
    ap.add_argument("--grid", type=parse_grid, default=None,
                    metavar="SPEC",
                    help="shape grid, e.g. 'm=256,512,1024;n=256,512' "
                         "(default: the quick 3×3 GEMM grid)")
    ap.add_argument("--budget-per-shape", type=int, default=None,
                    help="max proposals per shape (default: the sweep "
                         "strategy runs until the config space or the "
                         "evaluation budget is exhausted)")
    ap.add_argument("--predict", type=parse_shape, default=None,
                    metavar="SHAPE",
                    help="after the campaign, ask the oracle for this "
                         "shape's best config, e.g. 'm=768,n=640'")
    ap.add_argument("--oracle-eval", type=parse_shape, default=None,
                    metavar="SHAPE",
                    help="holdout mode: exclude SHAPE from the campaign, "
                         "predict its config, and report the gap to its "
                         "exhaustive optimum plus the trial savings")
    ap.add_argument("--no-tune", action="store_true",
                    help="skip the campaign run; answer --predict/"
                         "--oracle-eval from the existing cache only")
    ap.add_argument("--backend", type=parse_backend, default=None,
                    metavar="SPEC",
                    help="serial | thread[:N] (family closures do not "
                         "pickle into process workers)")
    ap.add_argument("--model", default="ridge", choices=("ridge", "knn"),
                    help="joint shape×config surrogate kind")
    ap.add_argument("--acquisition", default="ei", choices=("ei", "ucb"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="paper Table I budgets and the full shape grid "
                         "instead of quick ones")
    ap.add_argument("--cache-dir", default=".tuning_sessions")
    ap.add_argument("--fresh", action="store_true",
                    help="discard this campaign's cached trials first")
    ap.add_argument("--validate", default="warn",
                    choices=("off", "warn", "strict"),
                    help="pre-run workload audit of each shape (lint pass "
                         "1); 'strict' aborts on a mis-declared work term")
    ap.add_argument("--trace", nargs="?", const=True, default=False,
                    metavar="PATH",
                    help="record a span trace of the whole campaign "
                         "(default path <cache-dir>/<session>.trace.jsonl)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the benchmark runs (default: cuda; raises "
                         "when no card is visible)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..bench.common import (chunked_dgemm_family, gemm_shape_space,
                                paper_settings, sweep_chunk_space,
                                sweep_config_space, synthetic_gemm_family)
    from ..device import resolve_device

    device = resolve_device(args.device).type
    fingerprint = hardware_fingerprint(device)
    quick = not args.full
    shape_space = args.grid or gemm_shape_space(quick)
    if args.benchmark == "synthetic":
        family = synthetic_gemm_family
        config_space = sweep_config_space()
        settings = dataclasses.replace(
            paper_settings(True), max_invocations=2, max_iterations=3,
            use_inner_prune=True)
    else:
        family = functools.partial(chunked_dgemm_family, device=device)
        config_space = sweep_chunk_space()
        settings = dataclasses.replace(paper_settings(quick),
                                       use_ci_convergence=True,
                                       use_inner_prune=True,
                                       use_outer_prune=True)

    cache_path = pathlib.Path(args.cache_dir) / f"{args.session}.jsonl"
    if args.fresh and cache_path.exists():
        cache_path.unlink()

    # base = the benchmark family, not the session: one session cache can
    # hold synthetic and dgemm sweeps side by side without their per-shape
    # namespaces (and priors/oracle pools) colliding
    campaign = SweepCampaign(
        config_space, shape_space, family, settings, name=args.session,
        base=args.benchmark,
        cache_dir=args.cache_dir, budget_per_shape=args.budget_per_shape,
        model=args.model, acquisition=args.acquisition, seed=args.seed,
        fingerprint=fingerprint, validate=args.validate)

    n_shapes = shape_space.cardinality
    print(f"campaign   : {args.session}  ({cache_path})")
    print(f"fingerprint: {fingerprint}")
    print(f"shapes     : {shape_space!r}  ({n_shapes} shapes)")
    print(f"configs    : {config_space!r}  "
          f"({config_space.cardinality} per shape)")
    print(f"cached     : {len(TrialCache(cache_path, fingerprint))} trials")

    holdout = [args.oracle_eval] if args.oracle_eval is not None else []
    if not args.no_tune:
        result = campaign.run(holdout=holdout, backend=args.backend,
                              timestamp=time.time(), trace=args.trace)
        for o in result.outcomes:
            r = o.result
            print(f"  {shape_key(o.shape):>24s}: best={r.best_config} "
                  f"score={r.best_score:.3f} trials={len(r.trials)} "
                  f"(cached={r.n_cached}, pruned={r.n_pruned})")
        print(f"total      : {result.total_trials} trials across "
              f"{len(result.outcomes)} shapes "
              f"(exhaustive would be "
              f"{n_shapes * config_space.cardinality})")
        if result.trace_path:
            print(f"trace      : {result.trace_path}")

    oracle = campaign.oracle()
    regime = ("warm (joint model)" if oracle.is_warm()
              else "cold (nearest-shape fallback)")
    print(f"oracle     : {regime} — {oracle.n_trials} trials, "
          f"{len(oracle.tuned_shapes)} shapes")

    for label, shape in (("predict", args.predict),
                         ("eval", args.oracle_eval)):
        if shape is None:
            continue
        answer = oracle.best_for(shape)
        print(f"{label:<11s}: {shape_key(shape)} -> {answer.config} "
              f"[{answer.source}"
              + (f", predicted={answer.predicted:.3f}]"
                 if answer.predicted is not None else "]"))
        if label != "eval":
            continue
        # ground truth: exhaustive pass over the held-out shape, not
        # cached — the oracle must never see it
        truth = Tuner(config_space, settings).tune(family(shape),
                                                   validate=args.validate)
        want = config_key(answer.config)
        got = None
        for t in truth.trials:
            if config_key(t.config) == want and not t.result.pruned:
                got = t.result.score
        opt = truth.best_score
        if got is None:
            # pruning keeps the exhaustive pass cheap, but it leaves the
            # predicted config without a full score: measure it once more,
            # alone and unpruned (the JAX CLI reports no gap here)
            print("eval       : predicted config was pruned in the "
                  "ground-truth pass — re-measured alone, unpruned")
            alone = dataclasses.replace(settings, use_inner_prune=False,
                                        use_outer_prune=False)
            got = Tuner(SearchSpace([param(k, (v,)) for k, v in
                                     answer.config.items()]),
                        alone).tune(family(shape),
                                    validate=args.validate).best_score
        gap = abs(opt - got) / abs(opt) if opt else 0.0
        spent = campaign.oracle().n_trials
        budget = n_shapes * config_space.cardinality
        print(f"eval       : optimum={truth.best_config} score={opt:.3f}; "
              f"oracle config scored {got:.3f} (gap {100 * gap:.2f}%)")
        print(f"eval       : campaign spent {spent} trials vs {budget} "
              f"exhaustive ({100 * spent / budget:.0f}%)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
