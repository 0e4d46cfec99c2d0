"""Confidence intervals for benchmark sample streams.

The paper computes a normal-theory CI from the Welford moments after every
sample, and terminates the evaluation loop when the 99% CI is within +-1% of
the mean (stop condition 3), or when the CI upper bound drops below the
incumbent best (stop condition 4).

The paper notes (Sec. III-C.3) that benchmark runtimes are usually
*non-normal* and names bootstrapping as the ideal-but-too-expensive
alternative, leaving efficient online versions as future work (Sec. VII).
We implement that future work here:

  * normal CI        — the paper's default (n >= 30 rule of Georges et al.);
  * Student-t CI     — small-sample correction (exact under normality);
  * reservoir bootstrap CI — percentile bootstrap over a bounded reservoir,
    O(K) memory independent of stream length => "online" in the paper's sense;
  * median-of-means + sign-test CI — robust nonparametric location estimate.

No scipy available: the normal quantile uses Acklam's rational approximation
(|rel err| < 1.15e-9) and the t quantile inverts the incomplete-beta CDF by
bisection.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from .welford import WelfordState

# ---------------------------------------------------------------------------
# Quantiles (no scipy)
# ---------------------------------------------------------------------------


def normal_quantile(p: float) -> float:
    """Inverse standard-normal CDF, Acklam's algorithm."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0,1), got {p}")
    a = (-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00)
    b = (-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / (
        ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


def _betacf(a: float, b: float, x: float) -> float:
    """Continued fraction for the incomplete beta function (NR in C, 6.4)."""
    MAXIT, EPS, FPMIN = 200, 3e-12, 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < FPMIN:
        d = FPMIN
    d = 1.0 / d
    h = d
    for m in range(1, MAXIT + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < EPS:
            break
    return h


def _betainc(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a, b)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_bt = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
             + a * math.log(x) + b * math.log(1.0 - x))
    bt = math.exp(ln_bt)
    if x < (a + 1.0) / (a + b + 2.0):
        return bt * _betacf(a, b, x) / a
    return 1.0 - bt * _betacf(b, a, 1.0 - x) / b


def t_cdf(t: float, df: float) -> float:
    """CDF of Student's t with ``df`` degrees of freedom."""
    if df <= 0:
        raise ValueError("df must be positive")
    x = df / (df + t * t)
    p = 0.5 * _betainc(df / 2.0, 0.5, x)
    return 1.0 - p if t > 0 else p


def t_quantile(p: float, df: float) -> float:
    """Inverse t CDF by bisection (robust, ~1e-10 accurate, fast enough
    because stop-condition checks cache the quantile per (p, df))."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0,1), got {p}")
    if df <= 0:
        raise ValueError("df must be positive")
    if df > 1e6:
        return normal_quantile(p)
    if abs(p - 0.5) < 1e-15:
        return 0.0
    lo, hi = -1e3, 1e3
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if t_cdf(mid, df) < p:
            lo = mid
        else:
            hi = mid
        if hi - lo < 1e-12 * max(1.0, abs(lo)):
            break
    return 0.5 * (lo + hi)


_QUANTILE_CACHE: dict[tuple[float, float], float] = {}


def _critical_value(confidence: float, n: float, use_t: bool) -> float:
    p = 1.0 - (1.0 - confidence) / 2.0
    if use_t and n >= 2:
        key = (p, float(int(n)))
        if key not in _QUANTILE_CACHE:
            _QUANTILE_CACHE[key] = t_quantile(p, float(int(n)) - 1.0)
        return _QUANTILE_CACHE[key]
    key = (p, -1.0)
    if key not in _QUANTILE_CACHE:
        _QUANTILE_CACHE[key] = normal_quantile(p)
    return _QUANTILE_CACHE[key]


# ---------------------------------------------------------------------------
# Confidence interval of the mean (paper stop conditions 3 & 4)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Interval:
    lo: float
    hi: float
    mean: float

    @property
    def margin(self) -> float:
        """marg in the paper's Listing 1: half-width of the CI."""
        return 0.5 * (self.hi - self.lo)

    @property
    def relative_margin(self) -> float:
        """margin / |mean| — the paper terminates at 1% (stop condition 3)."""
        if self.mean == 0.0:
            return float("inf")
        return self.margin / abs(self.mean)


def ci_mean(state: WelfordState, confidence: float = 0.99,
            use_t: bool = True) -> Interval:
    """CI of the mean from Welford moments.

    The paper assumes normality (citing Georges et al.'s n>=30 rule); with
    ``use_t=True`` (default) we apply the Student-t small-sample correction,
    which converges to the paper's z interval as n grows.
    """
    n = float(state.count)
    mean = float(state.mean)
    if n < 2:
        return Interval(lo=-math.inf, hi=math.inf, mean=mean)
    crit = _critical_value(confidence, n, use_t)
    half = crit * float(state.sem)
    return Interval(lo=mean - half, hi=mean + half, mean=mean)


# ---------------------------------------------------------------------------
# Online (bounded-memory) bootstrap — the paper's Sec. VII future work
# ---------------------------------------------------------------------------


class ReservoirBootstrap:
    """Percentile-bootstrap CI over a uniform reservoir of the stream.

    The paper rejects bootstrapping because re-resampling the full history per
    iteration is too expensive. A reservoir of K samples is an unbiased
    uniform subsample of the stream, so bootstrapping the reservoir gives a
    bounded-cost online approximation: O(K) memory, O(B*K) per query (queries
    are issued only when a stop condition is actually evaluated).
    """

    def __init__(self, capacity: int = 256, resamples: int = 200, seed: int = 0):
        self.capacity = int(capacity)
        self.resamples = int(resamples)
        self._rng = np.random.default_rng(seed)
        self._buf: list[float] = []
        self._seen = 0

    def update(self, x: float) -> None:
        self._seen += 1
        if len(self._buf) < self.capacity:
            self._buf.append(float(x))
        else:
            j = int(self._rng.integers(0, self._seen))
            if j < self.capacity:
                self._buf[j] = float(x)

    @property
    def count(self) -> int:
        return self._seen

    def ci_mean(self, confidence: float = 0.99) -> Interval:
        if len(self._buf) < 2:
            return Interval(-math.inf, math.inf, float(np.mean(self._buf) if self._buf else 0.0))
        buf = np.asarray(self._buf)
        idx = self._rng.integers(0, len(buf), size=(self.resamples, len(buf)))
        means = buf[idx].mean(axis=1)
        alpha = (1.0 - confidence) / 2.0
        lo, hi = np.quantile(means, [alpha, 1.0 - alpha])
        return Interval(lo=float(lo), hi=float(hi), mean=float(buf.mean()))


# ---------------------------------------------------------------------------
# Robust nonparametric statistics (paper Sec. VII: "basing the stop
# conditions on other statistics, like the median")
# ---------------------------------------------------------------------------


def _average_ranks(xs: Sequence[float]) -> list[float]:
    """1-based ranks with ties sharing their average rank."""
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    ranks = [0.0] * len(xs)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        avg = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[order[k]] = avg
        i = j + 1
    return ranks


def spearman(xs: Sequence[float], ys: Sequence[float]) -> Optional[float]:
    """Spearman rank-correlation of two paired samples (average ranks for
    ties — the tie-robust form, not the 6Σd² shortcut). ``None`` when a
    side is degenerate (fewer than two pairs, or all values tied): rank
    agreement is undefined there, and consumers — e.g. transfer-seed
    donor ranking in :meth:`~repro_torch.core.cache.TrialCache.rank_donors` —
    treat it as "no signal" rather than 0.
    """
    if len(xs) != len(ys):
        raise ValueError("paired samples must have equal length")
    n = len(xs)
    if n < 2:
        return None
    rx, ry = _average_ranks(xs), _average_ranks(ys)
    mx, my = sum(rx) / n, sum(ry) / n
    cov = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    vx = sum((a - mx) ** 2 for a in rx)
    vy = sum((b - my) ** 2 for b in ry)
    if vx <= 0.0 or vy <= 0.0:
        return None
    return cov / math.sqrt(vx * vy)


def median_of_means(samples: Sequence[float], n_blocks: int = 8) -> float:
    xs = np.asarray(list(samples), dtype=np.float64)
    if xs.size == 0:
        raise ValueError("no samples")
    k = max(1, min(n_blocks, xs.size))
    blocks = np.array_split(xs, k)
    return float(np.median([b.mean() for b in blocks]))


def sign_test_median_ci(samples: Sequence[float],
                        confidence: float = 0.99) -> Interval:
    """Distribution-free CI for the median from order statistics.

    P(X_(r) < median < X_(n-r+1)) derives from the Binomial(n, 1/2) CDF; we
    pick the largest r whose coverage is >= ``confidence``.
    """
    xs = np.sort(np.asarray(list(samples), dtype=np.float64))
    n = xs.size
    if n < 2:
        m = float(xs[0]) if n else 0.0
        return Interval(-math.inf, math.inf, m)
    # Binomial(n, 1/2) CDF via cumulative sum of exact pmf (n is small here).
    pmf = np.array([math.comb(n, k) for k in range(n + 1)], dtype=np.float64)
    pmf /= 2.0 ** n
    cdf = np.cumsum(pmf)
    r_best = 0
    for r in range(1, n // 2 + 1):
        # coverage = P(r <= K <= n-r) where K ~ Bin(n, 1/2)
        coverage = cdf[n - r] - (cdf[r - 1] if r >= 1 else 0.0)
        if coverage >= confidence:
            r_best = r
        else:
            break
    med = float(np.median(xs))
    if r_best == 0:
        return Interval(-math.inf, math.inf, med)
    return Interval(lo=float(xs[r_best - 1]), hi=float(xs[n - r_best]), mean=med)
