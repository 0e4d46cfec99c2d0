"""Quickstart: CI-pruned autotuning benchmarking in ~40 lines.

Tunes the matmul dimensions for *this* device with the paper's optimized
stop conditions (C+I+O), prints the winner and the search-cost comparison
against the fixed-budget Default methodology. On the card the space is
the card-sized DGEMM space; ``--device cpu`` takes the host's.

  python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse
import dataclasses
import time

from repro_torch.bench.common import card_dgemm_space, dgemm_benchmark
from repro_torch.core import EvaluationSettings, Tuner, grid

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = ap.parse_args().device

# 1. declare the search space (paper Sec. IV: explicit, low-cardinality)
space = (card_dgemm_space() if device == "cuda" else
         grid(n=(256, 512, 1024), m=(256, 512, 1024), k=(64, 128, 256)))
print(f"search space: {space}")
bench = dgemm_benchmark(device)

# 2. the paper's two methodologies
default = EvaluationSettings(max_invocations=3, max_iterations=30,
                             max_time_s=1.0)
optimized = dataclasses.replace(default, use_ci_convergence=True,
                                use_inner_prune=True, use_outer_prune=True)

# 3. run both; stop condition 4 prunes configurations whose CI upper bound
#    cannot beat the incumbent best
t0 = time.perf_counter()
slow = Tuner(space, default).tune(bench)
t_default = time.perf_counter() - t0

t0 = time.perf_counter()
fast = Tuner(space, optimized).tune(bench)
t_opt = time.perf_counter() - t0

err = abs(fast.best_score - slow.best_score) / slow.best_score
print(f"Default  : {slow.best_score:7.1f} GFLOP/s at {slow.best_config} "
      f"({slow.total_samples} samples, {t_default:.1f}s)")
print(f"C+I+O    : {fast.best_score:7.1f} GFLOP/s at {fast.best_config} "
      f"({fast.total_samples} samples, {t_opt:.1f}s, "
      f"{fast.n_pruned} pruned)")
print(f"speedup  : {t_default / t_opt:.1f}x   result error: {err:.2%} "
      f"(paper criterion: < 2%)")
