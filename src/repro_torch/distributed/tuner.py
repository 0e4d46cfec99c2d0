"""Distributed CI-pruned autotuning (the JAX package's
``distributed/tuner.py``).

The paper runs one node's benchmark search serially. At fleet scale two
parallelization axes open up, both enabled by the *exact* parallel merge
of Welford moments (Chan, Golub & LeVeque):

  1. **Search-space sharding** — workers take a strided shard of the
     (ordered) configuration list; after every round the incumbent best
     is all-reduced so stop-condition 4 prunes against the *global* best.
     The scheduler is simulated with faithful per-worker wall-clock
     accounting (parallel time = max over workers).

  2. **Replicated evaluation** — several workers sample the *same*
     configuration and their (n, mean, M2) partials merge exactly, so the
     CI tightens ~sqrt(W) faster in wall-clock terms.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from ..core import welford
from ..core.confidence import Interval, ci_mean
from ..core.evaluator import EvaluationSettings, Evaluator, InvocationFactory
from ..core.executor import SimulatedShardedBackend, shard_configs  # noqa: F401 — re-export
from ..core.searchspace import Config, SearchSpace
from ..core.tuner import BenchmarkFactory, TrialRecord, Tuner

__all__ = ["DistributedTuner", "DistributedTuningResult",
           "replicated_evaluate", "shard_configs"]


@dataclasses.dataclass(frozen=True)
class DistributedTuningResult:
    best_config: Optional[Config]
    best_score: Optional[float]
    trials: tuple[TrialRecord, ...]
    total_samples: int
    serial_time_s: float           # sum of all trial times
    parallel_time_s: float         # max over workers (simulated wall clock)
    n_workers: int
    n_pruned: int

    @property
    def parallel_speedup(self) -> float:
        return self.serial_time_s / max(self.parallel_time_s, 1e-12)


class DistributedTuner:
    """Search-space-sharded tuning with per-round incumbent all-reduce: a
    shell over :class:`~repro_torch.core.executor.SimulatedShardedBackend`,
    which holds the round scheduling, strided sharding and per-worker
    wall-clock accounting shared with the serial and thread-pool paths of
    :class:`~repro_torch.core.tuner.Tuner`."""

    def __init__(self, space: SearchSpace, settings: EvaluationSettings,
                 n_workers: int = 4, order: str = "exhaustive",
                 seed: Optional[int] = None):
        self.space = space
        self.settings = settings
        self.n_workers = n_workers
        self.order = order
        self.seed = seed

    def tune(self, benchmark: BenchmarkFactory,
             cache=None) -> DistributedTuningResult:
        result = Tuner(self.space, self.settings, order=self.order,
                       seed=self.seed).tune(
            benchmark,
            backend=SimulatedShardedBackend(self.n_workers),
            cache=cache)
        return DistributedTuningResult(
            best_config=result.best_config, best_score=result.best_score,
            trials=result.trials,
            total_samples=result.total_samples,
            serial_time_s=result.serial_time_s,
            parallel_time_s=result.parallel_time_s,
            n_workers=self.n_workers,
            n_pruned=result.n_pruned)


def replicated_evaluate(make_invocation: InvocationFactory,
                        settings: EvaluationSettings, n_workers: int,
                        confidence: float = 0.99,
                        ) -> tuple[Interval, welford.WelfordState, float]:
    """Evaluate ONE configuration on ``n_workers`` workers and merge their
    sample streams exactly. Returns (CI of merged mean, merged state,
    simulated parallel wall-clock)."""
    evaluator = Evaluator(settings)
    partials = []
    wall = 0.0
    for _ in range(n_workers):
        t0 = time.perf_counter()
        res = evaluator.evaluate(make_invocation)
        wall = max(wall, time.perf_counter() - t0)
        for inv in res.invocations:
            # each invocation's full (n, mean, M2) — the merge is exact
            partials.append(welford.WelfordState(
                count=float(inv.count), mean=inv.mean, m2=inv.m2))
    merged = welford.tree_merge(partials)
    return ci_mean(merged, confidence), merged, wall
