"""Tables VIII-XI reproduction: evaluation-optimization comparison.

Runs the exhaustive DGEMM autotuning under every technique row of the
paper's tables — Default (fixed sample budget), Single, Confidence (C),
C+Inner, C+I+Outer, each ± search-order Reversal — plus the median-CI
row and the paper's two hand-tuned baselines, and reports search time,
speedup over Default, and result error vs the Default's answer (paper
criterion: < 2%), raw and after re-scoring every winner under one
common budget.

    python -m repro_torch.bench.optimizations [--full] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import time

from ..core import EvaluationSettings, Evaluator, Tuner, standard_techniques
from ..device import resolve_device
from .common import (bench_main, dgemm_benchmark, emit, paper_dgemm_space,
                     paper_settings, print_table)


def hand_tuned_rows(space, base: EvaluationSettings, ref_time: float,
                    ref_score: float, bench) -> list[dict]:
    """Paper Sec. VI-C: 'Hand-tuned Time' matches the optimized runtime with
    a fixed budget; 'Hand-tuned Accuracy' raises iterations until accuracy
    matches."""
    rows = []
    for label, iters in (("Hand-tuned Time", 3), ("Hand-tuned Accuracy", 12)):
        settings = dataclasses.replace(base, max_invocations=1,
                                       max_iterations=iters)
        t0 = time.perf_counter()
        result = Tuner(space, settings).tune(bench)
        dt = time.perf_counter() - t0
        err = abs(result.best_score - ref_score) / ref_score
        rows.append({"technique": label,
                     "best_gflops": round(result.best_score, 1),
                     "best_dims": _dims(result.best_config),
                     "time_s": round(dt, 2),
                     "speedup": f"{ref_time / dt:.2f}x",
                     "err_raw": f"{err:.2%}",
                     "err_refined": "-",
                     "samples": result.total_samples,
                     "pruned": result.n_pruned})
    return rows


def _dims(cfg) -> str:
    return f"{cfg['n']},{cfg['m']},{cfg['k']}" if cfg else "-"


def techniques(base: EvaluationSettings,
               ) -> dict[str, tuple[EvaluationSettings, str]]:
    """Every technique row: the paper's :func:`standard_techniques` plus
    C+I+O with the nonparametric median CI."""
    rows = standard_techniques(base)
    # beyond-paper row (the paper's §VII future work): C+I+O with the
    # nonparametric median CI — robust to scheduler-noise spikes that the
    # normal CI (and hence the mean-based rows) are sensitive to
    rows["C+I+O (median)"] = (dataclasses.replace(
        base, use_ci_convergence=True, use_inner_prune=True,
        use_outer_prune=True, ci_method="median"), "exhaustive")
    return rows


def run(quick: bool = True, device: str = "cuda") -> list[dict]:
    device = resolve_device(device).type
    space = paper_dgemm_space(quick, device)
    base = paper_settings(quick)
    bench = dgemm_benchmark(device)

    rows = []
    results = {}
    t_default = None
    for label, (settings, order) in techniques(base).items():
        t0 = time.perf_counter()
        result = Tuner(space, settings, order=order).tune(bench)
        dt = time.perf_counter() - t0
        results[label] = (result, dt)
        if label == "Default":
            t_default = dt
    ref_score = results["Default"][0].best_score

    # refined re-scoring: every technique's WINNING config is re-evaluated
    # under one common fixed long budget, so the result-error column
    # compares configuration choices rather than run-to-run timing jitter
    refine_settings = dataclasses.replace(
        base, max_invocations=2, max_iterations=120, max_time_s=4.0,
        use_ci_convergence=True)
    refiner = Evaluator(refine_settings)
    refined: dict[str, float] = {}
    for label, (result, _) in results.items():
        key = _dims(result.best_config)
        if key not in refined:
            refined[key] = refiner.evaluate(bench(result.best_config)).score
    ref_refined = refined[_dims(results["Default"][0].best_config)]

    for label, (result, dt) in results.items():
        err = abs(result.best_score - ref_score) / ref_score
        err_ref = abs(refined[_dims(result.best_config)] - ref_refined) \
            / ref_refined
        rows.append({"technique": label,
                     "best_gflops": round(result.best_score, 1),
                     "best_dims": _dims(result.best_config),
                     "time_s": round(dt, 2),
                     "speedup": f"{t_default / dt:.2f}x",
                     "err_raw": f"{err:.2%}",
                     "err_refined": f"{err_ref:.2%}",
                     "samples": result.total_samples,
                     "pruned": result.n_pruned})
        emit(f"optimizations/{label.replace('+', '_')}", dt * 1e6,
             f"gflops={result.best_score:.1f};err={err_ref:.4f};"
             f"samples={result.total_samples}")

    rows.extend(hand_tuned_rows(space, base, t_default, ref_score, bench))
    print_table("Tables VIII-XI analog: evaluation optimizations "
                f"(|S|={space.cardinality})", rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(bench_main(run, __doc__))
