"""Welford online moment accumulation (paper Eq. 5-7) + parallel merge.

The paper (Sec. III-C.3) uses Welford's online algorithm [Welford 1962] to
track the running mean and corrected sum of squares of benchmark samples
without storing them, so that a confidence interval can be computed after
every sample and the evaluation loop terminated as early as possible.

We provide:
  * ``WelfordState`` — an immutable snapshot (n, mean, m2) of Python floats.
  * ``update``      — one-sample Welford step (Eq. 6/7).
  * ``merge``       — exact pairwise combination of two partial streams
    (Chan, Golub & LeVeque 1979), so partial streams measured apart can be
    reduced exactly.
  * ``from_samples`` — bulk construction by folding (tests/oracles).
  * ``batch_state`` — the moments of a whole tensor of samples in one
    float64 reduction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import torch


@dataclasses.dataclass(frozen=True)
class WelfordState:
    """Running moments of a scalar sample stream.

    Attributes:
      count: number of samples accumulated (a float, as the moments are).
      mean:  running sample mean  (paper Eq. 6).
      m2:    corrected sum of squares C_n = sum (x_i - mean)^2 (paper Eq. 7).
    """

    count: float
    mean: float
    m2: float

    # ---- derived quantities -------------------------------------------------
    @property
    def variance(self) -> float:
        """Unbiased sample variance S^2 = C / (n - 1) (paper Eq. 5)."""
        n = self.count
        return self.m2 / (n - 1.0) if n > 1 else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(max(self.variance, 0.0))

    @property
    def sem(self) -> float:
        """Standard error of the mean."""
        n = self.count
        return self.std / math.sqrt(n) if n > 0 else float("inf")

    @property
    def cov(self) -> float:
        """Coefficient of variation (Georges et al. steady-state detector)."""
        m = self.mean
        return self.std / abs(m) if m != 0 else float("inf")


def init() -> WelfordState:
    """Empty accumulator (base case of paper Eq. 6/7: C_1 = 0, m_1 = x_1)."""
    return WelfordState(count=0.0, mean=0.0, m2=0.0)


def update(state: WelfordState, x: float) -> WelfordState:
    """One Welford step: fold sample ``x`` into ``state``.

    Implements the recurrences (paper Eq. 6 and Eq. 7):
        m_n = m_{n-1} + (x_n - m_{n-1}) / n
        C_n = C_{n-1} + (n-1)/n * (x_n - m_{n-1})^2
    """
    n = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / n
    # (n-1)/n * delta^2  ==  delta * (x - new_mean)
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(count=n, mean=mean, m2=m2)


def merge(a: WelfordState, b: WelfordState) -> WelfordState:
    """Exactly combine two partial Welford streams (Chan et al. 1979).

    n   = n_a + n_b
    mu  = (n_a mu_a + n_b mu_b) / n
    M2  = M2_a + M2_b + delta^2 * n_a n_b / n

    This is associative and commutative up to fp error, so it is a valid
    operand for tree reductions.
    """
    na, nb = a.count, b.count
    n = na + nb
    if n == 0:
        return init()
    delta = b.mean - a.mean
    mean = a.mean + delta * (nb / n)
    m2 = a.m2 + b.m2 + delta * delta * (na * nb / n)
    return WelfordState(count=n, mean=mean, m2=m2)


def from_samples(samples: Iterable[float]) -> WelfordState:
    """Fold an iterable of samples (reference path; used by tests as oracle)."""
    state = init()
    for x in samples:
        state = update(state, float(x))
    return state


def batch_state(samples) -> WelfordState:
    """Welford state of a whole 1-D array or tensor of samples.

    A two-pass float64 reduction (mean, then the centred sum of squares)
    on the samples' own device. The JAX package folds the samples through
    a float32 scan instead, so the two agree to float32 rounding, not
    bit for bit.
    """
    x = torch.as_tensor(samples).reshape(-1).to(torch.float64)
    n = x.numel()
    if n == 0:
        return init()
    mean = x.mean()
    m2 = ((x - mean) ** 2).sum()
    return WelfordState(count=float(n), mean=float(mean), m2=float(m2))


def tree_merge(states: list[WelfordState]) -> WelfordState:
    """Pairwise tree reduction of many partial states (numerically preferred
    over a left fold when the partials have very different counts)."""
    if not states:
        return init()
    layer = list(states)
    while len(layer) > 1:
        nxt = [merge(layer[i], layer[i + 1]) for i in range(0, len(layer) - 1, 2)]
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]
