"""Table VII analog: iteration counts required per stop condition.

The paper reports how many hand-tuned iterations match the optimized
pipeline's time (Iter_T) and accuracy (Iter_A). We report the empirical
per-configuration sample counts the CI machinery actually used: mean/min/
max iterations under Confidence and C+I+O vs the fixed Default budget.

    python -m repro_torch.bench.iteration_counts [--full] [--device cpu]
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Tuner
from ..device import resolve_device
from .common import (bench_main, dgemm_benchmark, emit, paper_dgemm_space,
                     paper_settings, print_table)


def run(quick: bool = True, device: str = "cuda") -> list[dict]:
    device = resolve_device(device).type
    space = paper_dgemm_space(quick, device)
    base = paper_settings(quick)
    bench = dgemm_benchmark(device)
    rows = []
    for label, settings in (
            ("Default", base),
            ("Confidence", dataclasses.replace(base,
                                               use_ci_convergence=True)),
            ("C+I+O", dataclasses.replace(base, use_ci_convergence=True,
                                          use_inner_prune=True,
                                          use_outer_prune=True))):
        result = Tuner(space, settings).tune(bench)
        counts = [inv.count for t in result.trials
                  for inv in t.result.invocations]
        rows.append({"technique": label,
                     "mean_iters": round(float(np.mean(counts)), 1),
                     "min_iters": int(np.min(counts)),
                     "max_iters": int(np.max(counts)),
                     "total_samples": result.total_samples})
        emit(f"iteration_counts/{label.replace('+', '_')}",
             float(np.mean(counts)),
             f"total={result.total_samples}")
    print_table("Table VII analog: per-configuration iteration counts", rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(bench_main(run, __doc__))
