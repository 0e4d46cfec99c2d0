"""First-class search strategies: a propose/observe (ask/tell) layer.

The paper's contribution is the *search procedure* — state-space reduction
plus CI-pruned exhaustive evaluation — but exhaustive visiting is only one
policy. Benchmarking-suite work (*Towards a Benchmarking Suite for Kernel
Tuners*, arXiv:2303.08976) argues tuners should expose interchangeable
search strategies over one evaluation harness, and GEMM landscapes are
rugged enough that adaptive orderings matter. This module is that layer:

  * :class:`SearchStrategy` — the protocol. ``reset(space, settings,
    seeds)`` initializes a run, ``ask(n)`` proposes the next
    :class:`~repro_torch.core.executor.Batch` (``n`` is the backend's preferred
    parallel width, a hint), ``tell(config, result)`` feeds an outcome
    back. The engine guarantees every outcome of a batch is told before
    the next ``ask`` — round-synchronized backends all-reduce the
    incumbent exactly at those boundaries.
  * :class:`ExhaustiveStrategy` — the paper's loop: canonical, reversed
    ("+R"), or seeded-random visit order over the whole space.
  * :class:`SuccessiveHalvingStrategy` — the former
    ``tune_successive_halving`` ported onto the protocol, so it now runs
    on every backend with caching, warm-start, and pruning accounting.
    Rungs raise the iteration budget by ``eta`` via per-batch settings
    overrides; CI-aware promotion is unchanged.
  * :class:`RandomSearchStrategy` — budgeted sampling without
    replacement, for spaces too large to exhaust.
  * :class:`NeighborhoodStrategy` — greedy steepest-ascent hill climbing
    over ``Param``-adjacent configurations, exploiting the ordered domains
    :class:`~repro_torch.core.searchspace.SearchSpace` already declares.

Transfer tuning: every strategy accepts warm-start ``seeds`` — in-space
configurations (the engine projects foreign ones via
``SearchSpace.project``), typically another benchmark's cached incumbents
from ``TrialCache.suggest_seeds``. Exhaustive/random front-load them;
neighborhood starts its climb from the best of them.

Strategy instances are reusable (``reset`` reinitializes) but not
concurrently shareable: one instance drives one ``Tuner.tune`` at a time.
"""

from __future__ import annotations

import dataclasses
import random as _random
from typing import Optional, Sequence

from .cache import config_key
from .evaluator import EvalResult, EvaluationSettings
from .executor import Batch
from .searchspace import Config, SearchSpace
from .stop_conditions import Direction

__all__ = ["ExhaustiveStrategy", "NeighborhoodStrategy",
           "RandomSearchStrategy", "SearchStrategy",
           "SuccessiveHalvingStrategy"]


def _seeded_front(seeds: Sequence[Config],
                  rest: Sequence[Config]) -> list[Config]:
    """Seeds first (deduplicated), then the remaining configs in order."""
    seen = set()
    out: list[Config] = []
    for cfg in list(seeds) + list(rest):
        key = config_key(cfg)
        if key not in seen:
            seen.add(key)
            out.append(cfg)
    return out


class SearchStrategy:
    """Propose/observe search policy driven by the :class:`Tuner` engine.

    The engine calls ``reset`` once per run, then alternates ``ask`` /
    ``tell`` until ``ask`` returns ``None``. ``ask(n)`` receives the
    executing backend's round width — its all-reduce batch size — or
    ``None`` when the backend imposes no round structure (serial, thread
    pool), in which case the strategy should propose its full natural
    unit (remaining queue, current rung, neighbor round) so unconstrained
    backends never barrier mid-unit. The returned batch size is the
    strategy's choice either way; an empty batch is treated as
    exhaustion. Results served from the trial cache are told like fresh
    ones.
    """

    name: str = "base"

    @staticmethod
    def _cap(n: Optional[int], remaining: int) -> int:
        """Batch size for a round width of ``n`` (``None``/0 — take all)."""
        return max(1, min(n, remaining)) if n else remaining

    @property
    def order_label(self) -> str:
        """Search-order tag recorded on :class:`TuningResult` (the paper's
        table rows key on it; only the exhaustive strategy varies it)."""
        return self.name

    def reset(self, space: SearchSpace, settings: EvaluationSettings,
              seeds: Sequence[Config] = ()) -> None:
        raise NotImplementedError

    def ask(self, n: int) -> Optional[Batch]:
        raise NotImplementedError

    def tell(self, config: Config, result: EvalResult) -> None:
        pass


class QueueStrategy(SearchStrategy):
    """Shared machinery for strategies that drain a pre-planned queue:
    ``reset`` fills ``_queue`` via :meth:`_plan`, ``ask`` slices it."""

    def __init__(self):
        self._queue: list[Config] = []
        self._pos = 0

    def _plan(self, space: SearchSpace,
              seeds: Sequence[Config]) -> list[Config]:
        raise NotImplementedError

    def reset(self, space, settings, seeds=()):
        self._queue = self._plan(space, seeds)
        self._pos = 0

    def ask(self, n):
        if self._pos >= len(self._queue):
            return None
        take = self._cap(n, len(self._queue) - self._pos)
        batch = self._queue[self._pos:self._pos + take]
        self._pos += len(batch)
        return Batch(tuple(batch))


class ExhaustiveStrategy(QueueStrategy):
    """The paper's search: visit every configuration once, in canonical,
    reversed ("+R" ablation), or seeded-random order. Warm-start seeds are
    moved to the front of the queue so a transferred incumbent is measured
    (and starts pruning) first."""

    name = "exhaustive"

    def __init__(self, order: str = "exhaustive", seed: Optional[int] = None):
        super().__init__()
        if order not in ("exhaustive", "reverse", "random"):
            raise ValueError(f"unknown order {order!r}")
        self.order = order
        self.seed = seed

    @property
    def order_label(self) -> str:
        return self.order

    def _plan(self, space, seeds):
        return _seeded_front(seeds, space.ordered(self.order, seed=self.seed))


class RandomSearchStrategy(QueueStrategy):
    """Budgeted random sampling without replacement — for spaces too large
    to exhaust. With a budget, the sample is drawn by reservoir over the
    constraint-filtered enumeration (O(budget) memory, no materialized
    space); seeds are evaluated first and count against the budget."""

    name = "random"

    def __init__(self, budget: Optional[int] = None, seed: Optional[int] = None):
        super().__init__()
        if budget is not None and budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        self.budget = budget
        self.seed = seed

    def _plan(self, space, seeds):
        if self.budget is None:
            return _seeded_front(seeds, space.ordered("random",
                                                      seed=self.seed))
        rng = _random.Random(self.seed if self.seed is not None else 0)
        reservoir: list[Config] = []
        for i, cfg in enumerate(space.configs()):
            if len(reservoir) < self.budget:
                reservoir.append(cfg)
            else:
                j = rng.randrange(i + 1)
                if j < self.budget:
                    reservoir[j] = cfg
        rng.shuffle(reservoir)          # visit order independent of draw
        return _seeded_front(seeds, reservoir)[:self.budget]


class SuccessiveHalvingStrategy(SearchStrategy):
    """Successive halving with CI-informed promotion (DESIGN.md §8.3),
    ported from the former ``tune_successive_halving`` loop.

    Rung *r* evaluates the survivors with an iteration budget that grows
    by ``eta`` per rung (a per-batch settings override:
    ``max_invocations=1, max_iterations=budget``); only the top ``1/eta``
    advance, where a configuration survives if its CI bound facing the
    cutoff still reaches it (the paper's Listing-1 logic as a promoter).
    Stop condition 4 still prunes doomed configs inside a rung — against
    the engine's shared incumbent cell, so on concurrent backends the
    pruning reference is the live (or round-frozen) global best.

    Because rung budgets differ from the tuner's base settings, rung
    evaluations are never *served* from the trial cache (they would
    truncate deeper rungs) and never seed a future session's incumbent
    (warm-start demands settings parity). They are still persisted under
    their own settings fingerprint — coexisting with, never shadowing,
    full-budget records of the same configs — feeding the dashboards and
    ``suggest_seeds`` transfer hints.
    """

    name = "halving"

    def __init__(self, eta: int = 3, min_iterations: int = 4):
        if eta < 2:
            raise ValueError(f"eta must be >= 2, got {eta}")
        if min_iterations < 1:
            raise ValueError(
                f"min_iterations must be >= 1, got {min_iterations}")
        self.eta = eta
        self.min_iterations = min_iterations

    def reset(self, space, settings, seeds=()):
        self._base = settings
        self._direction = settings.direction
        self._budget = self.min_iterations
        self._done = False
        self._start_rung(_seeded_front(seeds, space.ordered("exhaustive")))

    def _start_rung(self, survivors: list[Config]) -> None:
        self._pending = list(survivors)
        self._awaiting = len(survivors)
        self._scored: list[tuple[Config, EvalResult]] = []
        self._rung_settings = dataclasses.replace(
            self._base, max_invocations=1, max_iterations=self._budget)

    def ask(self, n):
        if self._done or not self._pending:
            return None
        batch = self._pending[:self._cap(n, len(self._pending))]
        del self._pending[:len(batch)]
        return Batch(tuple(batch), settings=self._rung_settings)

    def tell(self, config, result):
        if self._done:
            return
        if not result.pruned:
            self._scored.append((config, result))
        self._awaiting -= 1
        if self._awaiting == 0 and not self._pending:
            self._close_rung()

    def _close_rung(self) -> None:
        from .confidence import ci_mean
        from .welford import WelfordState

        direction = self._direction
        scored = self._scored
        if len(scored) <= 1:
            self._done = True
            return
        scored.sort(key=lambda cr: cr[1].score,
                    reverse=(direction is Direction.MAXIMIZE))
        keep = max(1, len(scored) // self.eta)
        cutoff = scored[keep - 1][1].score
        kept = []
        for cfg, res in scored:
            # CI-aware promotion: survive if the CI bound facing the cutoff
            # still reaches it
            state = WelfordState(count=float(res.total_samples),
                                 mean=res.score,
                                 m2=sum(i.m2 for i in res.invocations))
            interval = ci_mean(state, self._base.confidence)
            bound = interval.hi if direction is Direction.MAXIMIZE \
                else interval.lo
            if direction.better(bound, cutoff) or bound == cutoff or \
                    res.score == cutoff or direction.better(res.score,
                                                            cutoff):
                kept.append(cfg)
        survivors = kept[:max(1, len(scored) // self.eta)] \
            if len(kept) > len(scored) // self.eta else kept
        if len(survivors) <= 1:
            self._done = True
            return
        self._budget *= self.eta
        self._start_rung(survivors)


class NeighborhoodStrategy(SearchStrategy):
    """Greedy steepest-ascent hill climbing over ``Param``-adjacent
    configurations.

    Each round evaluates the unvisited neighbors of the current center —
    configurations differing by one step along one parameter's ordered
    domain — and moves to the best improving one; the climb stops at a
    local optimum or when ``budget`` evaluations have been proposed. The
    first round evaluates the starting point(s): the warm-start seeds when
    given (transfer tuning starts the climb at a related benchmark's
    incumbent), else the space's canonical first configuration. Pruned
    results carry truncated scores and never become the center.
    """

    name = "neighborhood"

    def __init__(self, budget: Optional[int] = None):
        if budget is not None and budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        self.budget = budget

    def reset(self, space, settings, seeds=()):
        self._space = space
        self._direction = settings.direction
        self._visited: set[str] = set()
        self._center: Optional[Config] = None
        self._center_score: Optional[float] = None
        self._round: list[tuple[Config, EvalResult]] = []
        self._awaiting = 0
        self._proposed = 0
        self._done = False
        starts = list(seeds)
        if not starts:
            first = next(space.configs(), None)
            if first is not None:
                starts = [first]
        self._pending = _seeded_front(starts, ())
        if not self._pending:
            self._done = True

    def _remaining_budget(self) -> Optional[int]:
        if self.budget is None:
            return None
        return self.budget - self._proposed

    def ask(self, n):
        if self._done or not self._pending:
            return None
        limit = self._cap(n, len(self._pending))
        remaining = self._remaining_budget()
        if remaining is not None:
            if remaining <= 0:
                self._done = True
                return None
            limit = min(limit, remaining)
        batch = self._pending[:limit]
        del self._pending[:len(batch)]
        for cfg in batch:
            self._visited.add(config_key(cfg))
        self._proposed += len(batch)
        self._awaiting += len(batch)
        return Batch(tuple(batch))

    def tell(self, config, result):
        if self._done:
            return
        self._visited.add(config_key(config))
        self._round.append((config, result))
        self._awaiting -= 1
        budget_left = self._remaining_budget()
        exhausted = budget_left is not None and budget_left <= 0
        if self._awaiting == 0 and (not self._pending or exhausted):
            self._close_round()

    def _best_of_round(self) -> Optional[tuple[Config, float]]:
        best: Optional[tuple[Config, float]] = None
        for cfg, res in self._round:
            if res.pruned:
                continue
            if best is None or self._direction.better(res.score, best[1]):
                best = (cfg, res.score)
        return best

    def _close_round(self) -> None:
        candidate = self._best_of_round()
        self._round = []
        improved = candidate is not None and (
            self._center_score is None
            or self._direction.better(candidate[1], self._center_score))
        budget_left = self._remaining_budget()
        if not improved or (budget_left is not None and budget_left <= 0):
            self._done = True
            return
        self._center, self._center_score = candidate
        self._pending = self._neighbors(self._center)
        if not self._pending:
            self._done = True

    def _neighbors(self, center: Config) -> list[Config]:
        out: list[Config] = []
        for p in self._space.params:
            try:
                idx = p.values.index(center[p.name])
            except (KeyError, ValueError):
                continue
            for step in (-1, 1):
                j = idx + step
                if not 0 <= j < len(p.values):
                    continue
                cfg = dict(center)
                cfg[p.name] = p.values[j]
                if config_key(cfg) in self._visited:
                    continue
                if not self._space._satisfies(cfg):
                    continue
                out.append(cfg)
        return out
