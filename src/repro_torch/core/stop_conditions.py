"""The paper's four stop conditions (Sec. III-C) as composable objects.

Each condition inspects an :class:`EvalContext` snapshot after every sample
and may return a :class:`StopDecision`. The evaluator runs the conditions in
order and stops at the first decision.

  1. ``MaxTime``       — accumulated-time budget cap (``-t`` flag).
  2. ``MaxCount``      — iteration-count cap (escape hatch for high-variance
                         configurations whose CI converges slowly).
  3. ``CIConverged``   — "Confidence"/C: stop when the ``confidence`` CI of
                         the mean is within ``rel_margin`` of the mean.
  4. ``UpperBoundPrune`` — "Inner"/"Outer" (I/O): stop when the CI bound
                         facing the incumbent shows the current configuration
                         is very unlikely to beat the best-so-far
                         (paper Listing 1: ``if mean + marg < best: break``).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence

from . import confidence as confidence_mod
from .welford import WelfordState


class Direction(enum.Enum):
    """Whether larger or smaller metric values are better.

    The paper maximizes GFLOP/s; tuning on wall-time minimizes. All CI logic
    is direction-aware so the same machinery serves both.
    """

    MAXIMIZE = "maximize"
    MINIMIZE = "minimize"

    def better(self, a: float, b: float) -> bool:
        """True iff ``a`` is strictly better than ``b``."""
        return a > b if self is Direction.MAXIMIZE else a < b


@dataclasses.dataclass(frozen=True)
class EvalContext:
    """Snapshot the evaluator hands to each stop condition.

    ``ci_fn`` optionally overrides how the confidence interval is computed
    (paper §VII future work: bootstrap / median-based statistics — see
    ``EvaluationSettings.ci_method``). Default: normal/t CI from the
    Welford moments, as in the paper.
    """

    welford: WelfordState
    elapsed_s: float
    count: int
    incumbent: Optional[float]  # best score seen across configurations
    direction: Direction
    ci_fn: Optional[object] = None  # Callable[[float, bool], Interval]

    def interval(self, confidence: float, use_t: bool):
        if self.ci_fn is not None:
            return self.ci_fn(confidence, use_t)
        return confidence_mod.ci_mean(self.welford, confidence, use_t)


@dataclasses.dataclass(frozen=True)
class StopDecision:
    reason: str
    pruned: bool = False  # True iff stopped because it cannot win (cond. 4)


class StopCondition:
    name: str = "base"

    def check(self, ctx: EvalContext) -> Optional[StopDecision]:
        raise NotImplementedError


@dataclasses.dataclass
class MaxTime(StopCondition):
    """Stop condition 1: total measured time exceeds ``max_seconds``."""

    max_seconds: float
    name: str = "max_time"

    def check(self, ctx: EvalContext) -> Optional[StopDecision]:
        if ctx.elapsed_s >= self.max_seconds:
            return StopDecision(reason=f"max_time({self.max_seconds}s)")
        return None


@dataclasses.dataclass
class MaxCount(StopCondition):
    """Stop condition 2: sample count exceeds ``max_count``."""

    max_count: int
    name: str = "max_count"

    def check(self, ctx: EvalContext) -> Optional[StopDecision]:
        if ctx.count >= self.max_count:
            return StopDecision(reason=f"max_count({self.max_count})")
        return None


@dataclasses.dataclass
class CIConverged(StopCondition):
    """Stop condition 3 ("Confidence"): CI half-width within ``rel_margin``
    of the mean at ``confidence`` level. Paper defaults: 99% / 1%."""

    confidence: float = 0.99
    rel_margin: float = 0.01
    min_count: int = 5
    use_t: bool = True
    name: str = "ci_converged"

    def check(self, ctx: EvalContext) -> Optional[StopDecision]:
        if ctx.count < self.min_count:
            return None
        interval = ctx.interval(self.confidence, self.use_t)
        if interval.relative_margin <= self.rel_margin:
            return StopDecision(
                reason=f"ci_converged(±{interval.relative_margin:.3%})")
        return None


@dataclasses.dataclass
class UpperBoundPrune(StopCondition):
    """Stop condition 4: CI bound facing the incumbent cannot beat it.

    For MAXIMIZE this is the paper's Listing 1 literally:
        if mean + marg < best: break
    For MINIMIZE the mirrored test is ``mean - marg > best``.

    ``min_count`` is the paper's guard for configurations whose performance
    climbs during evaluation (2695v4 needed min_count=100 to avoid discarding
    the true optimum).
    """

    confidence: float = 0.99
    min_count: int = 2
    use_t: bool = True
    name: str = "upper_bound_prune"

    def check(self, ctx: EvalContext) -> Optional[StopDecision]:
        if ctx.incumbent is None or ctx.count < self.min_count:
            return None
        interval = ctx.interval(self.confidence, self.use_t)
        marg = interval.margin
        if not math.isfinite(marg):
            return None
        if ctx.direction is Direction.MAXIMIZE:
            doomed = interval.mean + marg < ctx.incumbent
        else:
            doomed = interval.mean - marg > ctx.incumbent
        if doomed:
            return StopDecision(
                reason=f"upper_bound_prune(bound={interval.mean:+.4g}±{marg:.4g} "
                       f"vs incumbent={ctx.incumbent:.4g})",
                pruned=True)
        return None


def first_decision(conditions: Sequence[StopCondition],
                   ctx: EvalContext) -> Optional[StopDecision]:
    for cond in conditions:
        decision = cond.check(ctx)
        if decision is not None:
            return decision
    return None
