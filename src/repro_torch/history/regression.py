"""Statistical drift detection over ledger series (regression gating).

The paper trusts a measured peak only when its confidence interval says
so; this module applies the same discipline *across* runs. For each
(benchmark, fingerprint) series in a :class:`~repro_torch.history.ledger.RunLedger`,
the newest run's incumbent mean is compared against the **best historical
run** (not merely the previous one — a slow decay must not hide behind a
chain of individually-insignificant steps):

  * **Welch CI on the difference of means** — the default. Both runs'
    pooled Welford moments give a two-sample t interval with
    Welch–Satterthwaite degrees of freedom, built on the same quantile
    machinery as :mod:`repro_torch.core.confidence` (no scipy).
  * **Reservoir-bootstrap fallback** — when either run pooled fewer than
    ``min_count`` samples the t approximation is shaky, so the stored
    per-invocation means are resampled with
    :class:`~repro_torch.core.confidence.ReservoirBootstrap` and the verdict
    comes from percentile-CI overlap.

A drift is only *confirmed* (verdict ``regressed`` / ``improved``) when
the CI excludes zero **and** the effect exceeds ``min_effect`` (default
2%, the paper's early-termination error budget) — statistically
significant noise below that threshold is classified ``flat``. Verdicts
aggregate into a :class:`RegressionReport`, which ``python -m
repro_torch.perf_gate`` turns into a CI exit code.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from ..core.confidence import Interval, ReservoirBootstrap, t_quantile
from ..core.stop_conditions import Direction
from ..core.welford import WelfordState

from .ledger import RunLedger, RunRecord

__all__ = ["RegressionReport", "RunComparison", "SeriesVerdict",
           "compare_runs", "detect_regressions", "welch_interval"]

#: Minimum pooled sample count per run for the Welch path; below it the
#: reservoir-bootstrap fallback takes over (when invocation means exist).
MIN_COUNT_WELCH = 5

#: Confirmed drifts must exceed this relative effect size — the paper's
#: <2% error discipline for early termination, applied to gating.
MIN_EFFECT = 0.02


def welch_interval(a: WelfordState, b: WelfordState,
                   confidence: float = 0.99) -> Interval:
    """CI for the difference of means ``b - a`` from two Welford states
    (Welch's t interval, Welch–Satterthwaite degrees of freedom).

    Degenerate inputs fall back conservatively: with fewer than two
    samples on either side the interval is infinite; with zero variance
    on both sides it collapses to the exact difference.
    """
    na, nb = float(a.count), float(b.count)
    delta = float(b.mean) - float(a.mean)
    if na < 2 or nb < 2:
        return Interval(lo=-math.inf, hi=math.inf, mean=delta)
    va, vb = float(a.variance), float(b.variance)
    se2 = va / na + vb / nb
    if se2 <= 0.0:
        return Interval(lo=delta, hi=delta, mean=delta)
    # Welch–Satterthwaite: df of the combined variance estimate
    df = se2 * se2 / ((va / na) ** 2 / (na - 1.0)
                      + (vb / nb) ** 2 / (nb - 1.0))
    crit = t_quantile(1.0 - (1.0 - confidence) / 2.0, max(df, 1.0))
    half = crit * math.sqrt(se2)
    return Interval(lo=delta - half, hi=delta + half, mean=delta)


@dataclasses.dataclass(frozen=True)
class RunComparison:
    """Outcome of comparing a candidate run against a baseline run."""

    baseline: RunRecord
    candidate: RunRecord
    delta: float                   # candidate.mean - baseline.mean
    rel_delta: float               # delta / |baseline.mean|
    interval: Interval             # CI of the difference (welch) or of the
                                   # candidate (bootstrap overlap test)
    verdict: str                   # "improved" | "flat" | "regressed"
    method: str                    # "welch" | "bootstrap"
    confidence: float


def _bootstrap_ci(means: Sequence[float], confidence: float,
                  seed: int) -> Interval:
    boot = ReservoirBootstrap(seed=seed)
    for x in means:
        boot.update(float(x))
    return boot.ci_mean(confidence)


def compare_runs(baseline: RunRecord, candidate: RunRecord,
                 confidence: float = 0.99,
                 direction: Optional[Direction] = None,
                 min_effect: float = MIN_EFFECT,
                 min_count: int = MIN_COUNT_WELCH) -> RunComparison:
    """Classify ``candidate`` against ``baseline``.

    ``direction`` defaults to the direction stamped on the candidate
    record. The verdict is direction-aware: under MINIMIZE a significant
    *increase* of the mean is the regression.
    """
    if direction is None:
        direction = Direction(candidate.direction)
    delta = candidate.mean - baseline.mean
    rel = delta / abs(baseline.mean) if baseline.mean else math.inf
    small_n = (baseline.count < min_count or candidate.count < min_count)
    if small_n and len(baseline.invocation_means) >= 2 \
            and len(candidate.invocation_means) >= 2:
        # percentile-CI overlap over the stored invocation means; seeds
        # derive from the run indices so reruns reproduce the verdict
        ca = _bootstrap_ci(baseline.invocation_means, confidence,
                           seed=baseline.run + 1)
        cb = _bootstrap_ci(candidate.invocation_means, confidence,
                           seed=candidate.run + 1)
        separated_up = cb.lo > ca.hi
        separated_down = cb.hi < ca.lo
        method, interval = "bootstrap", cb
    else:
        interval = welch_interval(baseline.state, candidate.state, confidence)
        separated_up = interval.lo > 0.0
        separated_down = interval.hi < 0.0
        method = "welch"
    confirmed = (separated_up or separated_down) and abs(rel) >= min_effect
    if not confirmed:
        verdict = "flat"
    else:
        got_better = direction.better(candidate.mean, baseline.mean)
        verdict = "improved" if got_better else "regressed"
    return RunComparison(baseline=baseline, candidate=candidate, delta=delta,
                         rel_delta=rel, interval=interval, verdict=verdict,
                         method=method, confidence=confidence)


@dataclasses.dataclass(frozen=True)
class SeriesVerdict:
    """One (benchmark, fingerprint) series' drift classification."""

    benchmark: str
    fingerprint: str
    runs: tuple[RunRecord, ...]
    comparison: Optional[RunComparison]   # None: single-run series

    @property
    def verdict(self) -> str:
        """"baseline" for single-run series, else the comparison's."""
        return self.comparison.verdict if self.comparison else "baseline"

    @property
    def scores(self) -> tuple[float, ...]:
        return tuple(r.score for r in self.runs)


@dataclasses.dataclass(frozen=True)
class RegressionReport:
    """Every series' verdict; ``ok`` is the gate's pass/fail."""

    series: tuple[SeriesVerdict, ...]
    confidence: float
    min_effect: float

    @property
    def regressions(self) -> tuple[SeriesVerdict, ...]:
        return tuple(s for s in self.series if s.verdict == "regressed")

    @property
    def ok(self) -> bool:
        return not self.regressions

    def render_text(self) -> str:
        """Terminal rendering: one sparkline-annotated line per series,
        then the gate verdict."""
        from .render import ascii_sparkline
        if not self.series:
            return "perf-gate: ledger has no runs — nothing to gate.\n"
        lines = []
        width = max(len(f"{s.benchmark} @ {s.fingerprint}")
                    for s in self.series)
        for s in self.series:
            name = f"{s.benchmark} @ {s.fingerprint}".ljust(width)
            spark = ascii_sparkline(s.scores)
            if s.comparison is None:
                lines.append(f"  {name}  {spark}  baseline "
                             f"({s.runs[-1].score:.4g}, 1 run)")
                continue
            c = s.comparison
            tag = s.verdict.upper() if s.verdict == "regressed" else s.verdict
            lines.append(
                f"  {name}  {spark}  {tag}  "
                f"run {c.candidate.run}: {c.candidate.mean:.4g} vs best "
                f"run {c.baseline.run}: {c.baseline.mean:.4g} "
                f"({c.rel_delta:+.2%}, {c.method}, "
                f"{c.confidence * 100:g}% CI "
                f"[{c.interval.lo:.4g}, {c.interval.hi:.4g}])")
        n_reg = len(self.regressions)
        head = (f"perf-gate: {len(self.series)} series, "
                f"{n_reg} confirmed regression(s) "
                f"(confidence={self.confidence:g}, "
                f"min_effect={self.min_effect:.0%})")
        return "\n".join([head, *lines]) + "\n"


def detect_regressions(ledger: RunLedger,
                       benchmark: Optional[str] = None,
                       fingerprint: Optional[str] = None,
                       confidence: float = 0.99,
                       direction: Optional[Direction] = None,
                       min_effect: float = MIN_EFFECT,
                       min_count: int = MIN_COUNT_WELCH) -> RegressionReport:
    """Compare every series' newest run against its best historical run.

    The baseline is the direction-best run among all *earlier* runs, so a
    gradual drift cannot hide: run N is always held to the series' high-
    water mark, not to run N-1. Single-run series classify ``baseline``
    and never gate.
    """
    out = []
    for bench, fp in ledger.keys():
        if benchmark is not None and bench != benchmark:
            continue
        if fingerprint is not None and fp != fingerprint:
            continue
        runs = tuple(ledger.series(bench, fp))
        if len(runs) < 2:
            out.append(SeriesVerdict(bench, fp, runs, None))
            continue
        candidate = runs[-1]
        d = direction or Direction(candidate.direction)
        baseline = runs[0]
        for r in runs[1:-1]:
            if d.better(r.mean, baseline.mean):
                baseline = r
        cmp = compare_runs(baseline, candidate, confidence=confidence,
                           direction=d, min_effect=min_effect,
                           min_count=min_count)
        out.append(SeriesVerdict(bench, fp, runs, cmp))
    return RegressionReport(series=tuple(out), confidence=confidence,
                            min_effect=min_effect)
