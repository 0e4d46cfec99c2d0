"""Acquisition functions: where should the next trial be spent?

Given a surrogate's predictive (mean, std) per candidate, an acquisition
function scores how much a trial there is worth. Both implementations
reuse the CI machinery in :mod:`repro_torch.core.confidence` so acquisition
respects the paper's noise model rather than inventing its own:

  * **UCB** uses the same normal quantile the paper's stop conditions use
    — ``kappa = normal_quantile(confidence)`` — so "optimistic" means
    exactly "the edge of the (one-sided) confidence band" at the
    confidence level the evaluation settings already declare.
  * **Expected Improvement** is computed against a *noise-adjusted*
    incumbent: :func:`noise_adjusted_best` pushes the reference to the
    incumbent's own CI bound facing the search direction
    (:func:`repro_torch.core.confidence.ci_mean` over the incumbent trial's
    pooled Welford moments). A candidate must therefore promise
    improvement beyond the band the incumbent's score could wander in
    from measurement noise alone — the same reasoning behind the paper's
    stop condition 4 — and the default exploration margin ``xi`` is the
    settings' ``rel_margin`` (the paper's 1% CI-convergence threshold).

Scores are always "higher is better" regardless of the tuning direction;
minimization is handled by sign-flipping means internally.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..core.confidence import ci_mean, normal_quantile
from ..core.stop_conditions import Direction
from ..core.welford import WelfordState

__all__ = ["expected_improvement", "noise_adjusted_best", "normal_cdf",
           "normal_pdf", "upper_confidence_bound"]


def normal_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * np.square(z)) / math.sqrt(2.0 * math.pi)


_erf = np.vectorize(math.erf, otypes=[np.float64])


def normal_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + _erf(np.asarray(z) / math.sqrt(2.0)))


def _signed(mean: np.ndarray, direction: Direction) -> np.ndarray:
    """Fold direction into the mean: after this, bigger is better."""
    return np.asarray(mean, dtype=np.float64) \
        if direction is Direction.MAXIMIZE else -np.asarray(mean,
                                                            dtype=np.float64)


def noise_adjusted_best(state: WelfordState, confidence: float,
                        direction: Direction) -> float:
    """The incumbent reference EI should beat: the CI bound of the
    incumbent's own sample stream facing the search direction (upper for
    maximize, lower for minimize). With fewer than two samples the CI is
    unbounded, so the mean itself is returned."""
    interval = ci_mean(state, confidence)
    bound = interval.hi if direction is Direction.MAXIMIZE else interval.lo
    return float(bound) if math.isfinite(bound) else float(interval.mean)


def expected_improvement(mean: np.ndarray, std: np.ndarray, best: float,
                         direction: Direction = Direction.MAXIMIZE,
                         xi: float = 0.01) -> np.ndarray:
    """E[max(improvement over ``best``, 0)] under the surrogate's normal
    predictive distribution. ``xi`` is the relative exploration margin —
    pass the settings' ``rel_margin`` so "improvement" means the same
    thing as the paper's CI-convergence threshold."""
    mu = _signed(mean, direction)
    best_s = best if direction is Direction.MAXIMIZE else -best
    std = np.maximum(np.asarray(std, dtype=np.float64), 0.0)
    target = best_s + xi * abs(best_s)
    delta = mu - target
    out = np.maximum(delta, 0.0)
    pos = std > 0
    z = delta[pos] / std[pos]
    out[pos] = delta[pos] * normal_cdf(z) + std[pos] * normal_pdf(z)
    return out


def upper_confidence_bound(mean: np.ndarray, std: np.ndarray,
                           direction: Direction = Direction.MAXIMIZE,
                           confidence: float = 0.99,
                           kappa: Optional[float] = None) -> np.ndarray:
    """Optimism in the face of uncertainty at the paper's confidence
    level: mean + kappa·std (sign-folded), kappa the one-sided normal
    quantile of ``confidence`` unless given explicitly."""
    if kappa is None:
        kappa = normal_quantile(confidence)
    return _signed(mean, direction) \
        + kappa * np.maximum(np.asarray(std, dtype=np.float64), 0.0)
