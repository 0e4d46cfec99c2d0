"""Two-level benchmark evaluation (paper Fig. 2).

The paper evaluates every configuration with an *inner iteration loop*
(repeated timed calls inside one process) nested in an *outer invocation
loop* (fresh process/JIT state per invocation, after Georges et al.'s
VM-invocation-level repetition). Both loops carry their own Welford stream
and their own stop conditions:

  inner:  MaxTime + MaxCount + [CIConverged "C"] + [UpperBoundPrune "I"]
  outer:  MaxCount(invocations) + [CIConverged] + [UpperBoundPrune "O"]

``Evaluator.evaluate`` runs the full two-level process for one configuration
and returns an :class:`EvalResult` with the score (mean of invocation means),
sample/timing accounting, and the stop reasons — everything the benchmark
tables in the paper report (iteration counts, search time, result).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import TYPE_CHECKING, Any, Callable, Optional, Sequence, Union

from . import welford
from .profiling import (phase, record_phase, trace_instant, trace_sink,
                        trace_span)
from .stop_conditions import (CIConverged, Direction, EvalContext, MaxCount,
                              MaxTime, StopCondition, StopDecision,
                              UpperBoundPrune, first_decision)

if TYPE_CHECKING:
    from .card_clock import CardClock

# ``make_invocation()`` models one outer-loop program invocation: it performs
# per-invocation setup (allocation, kernel resolution, pre-heat — the paper
# pre-heats with one untimed DGEMM call) and returns a zero-arg sampler producing one metric
# observation per call (e.g. GFLOP/s of one timed kernel execution).
InvocationFactory = Callable[[], Callable[[], float]]

# The pruning reference (stop condition 4): a fixed score, absent, or a
# zero-arg supplier of the live global best (IncumbentCell.get) that
# concurrent backends re-read before every sample.
Incumbent = Union[float, Callable[[], Optional[float]], None]


@dataclasses.dataclass(frozen=True)
class InvocationResult:
    mean: float
    count: int
    elapsed_s: float
    stop_reason: str
    pruned: bool
    m2: float = 0.0   # corrected sum of squares — enables exact downstream
                      # Welford merges (distributed tuner)


@dataclasses.dataclass(frozen=True)
class EvalResult:
    """Outcome of evaluating one configuration."""

    score: float                      # mean of invocation means
    best_invocation: float
    invocations: tuple[InvocationResult, ...]
    total_samples: int
    total_time_s: float               # wall time incl. setup
    measured_time_s: float            # sum of timed sample durations only
    pruned: bool                      # stopped by condition 4 at any level
    stop_reason: str                  # outer-level stop reason


@dataclasses.dataclass
class EvaluationSettings:
    """Mirrors the paper's Table I auto-tuner configuration.

    The optimization flags map to the paper's technique labels:
      use_ci_convergence -> "C"  (stop condition 3, inner loop)
      use_inner_prune    -> "I"  (stop condition 4, iteration loop)
      use_outer_prune    -> "O"  (stop condition 4, invocation loop)
    With all three False the evaluator degenerates to the fixed-sample-size
    "Default" methodology the paper benchmarks against.
    """

    max_invocations: int = 10
    max_iterations: int = 200
    max_time_s: float = 10.0
    confidence: float = 0.99
    rel_margin: float = 0.01
    use_ci_convergence: bool = False
    use_inner_prune: bool = False
    use_outer_prune: bool = False
    min_count_ci: int = 5
    min_count_inner: int = 2
    min_count_outer: int = 2
    direction: Direction = Direction.MAXIMIZE
    use_t: bool = True
    # CI method for the inner loop (paper §VII future work, implemented):
    # "welford"   — normal/t interval from online moments (the paper)
    # "bootstrap" — percentile bootstrap over a bounded reservoir
    # "median"    — sign-test CI for the median (nonparametric)
    ci_method: str = "welford"
    bootstrap_capacity: int = 256
    bootstrap_resamples: int = 200
    # Opt-in on-device timing (repro_torch.obs.device_timing): when a
    # trace recorder is installed, trials that beat the incumbent get one
    # extra profiled sample whose kernel time and host-vs-device skew land
    # in the trace. On the host it degrades to an "unavailable"
    # instant; on the card a lost kernel track raises. Never touches the
    # measured samples.
    device_timing: bool = False

    def label(self) -> str:
        """Technique label as used in the paper's tables, e.g. 'C+I+O'."""
        parts = []
        if self.use_ci_convergence:
            parts.append("C")
        if self.use_inner_prune:
            parts.append("I")
        if self.use_outer_prune:
            parts.append("O")
        return "+".join(parts) if parts else "Default"

    # -- condition stacks ----------------------------------------------------
    def inner_conditions(self) -> list[StopCondition]:
        conds: list[StopCondition] = [
            MaxTime(self.max_time_s),
            MaxCount(self.max_iterations),
        ]
        if self.use_ci_convergence:
            conds.append(CIConverged(self.confidence, self.rel_margin,
                                     min_count=self.min_count_ci,
                                     use_t=self.use_t))
        if self.use_inner_prune:
            conds.append(UpperBoundPrune(self.confidence,
                                         min_count=self.min_count_inner,
                                         use_t=self.use_t))
        return conds

    def outer_conditions(self) -> list[StopCondition]:
        conds: list[StopCondition] = [MaxCount(self.max_invocations)]
        if self.use_ci_convergence:
            conds.append(CIConverged(self.confidence, self.rel_margin,
                                     min_count=min(3, self.max_invocations),
                                     use_t=self.use_t))
        if self.use_outer_prune:
            conds.append(UpperBoundPrune(self.confidence,
                                         min_count=self.min_count_outer,
                                         use_t=self.use_t))
        return conds


def _resolve_incumbent(incumbent: Incumbent) -> Optional[float]:
    """The incumbent may be a scalar or a zero-arg supplier of the *live*
    global best (concurrent backends share it through an IncumbentCell)."""
    return incumbent() if callable(incumbent) else incumbent


class Evaluator:
    """Runs the two-level evaluation process for one configuration.

    ``evaluate`` is re-entrant: all mutable state is local, so one
    Evaluator instance may serve many threads concurrently (the
    ThreadPoolBackend relies on this).
    """

    def __init__(self, settings: EvaluationSettings,
                 clock: Callable[[], float] = time.perf_counter):
        self.settings = settings
        self.clock = clock

    # -- inner loop -----------------------------------------------------------
    def _run_invocation(self, sample_fn: Callable[[], float],
                        incumbent: Incumbent,
                        conditions: Sequence[StopCondition]) -> InvocationResult:
        from .confidence import ReservoirBootstrap, sign_test_median_ci
        s = self.settings
        state = welford.init()
        boot = ReservoirBootstrap(s.bootstrap_capacity,
                                  s.bootstrap_resamples) \
            if s.ci_method == "bootstrap" else None
        samples: list[float] = [] if s.ci_method == "median" else None
        t0 = self.clock()
        count = 0
        decision: Optional[StopDecision] = None
        while True:
            x = float(sample_fn())
            count += 1
            with phase("stats"):
                state = welford.update(state, x)
                ci_fn = None
                if boot is not None:
                    boot.update(x)
                    ci_fn = lambda conf, _t: boot.ci_mean(conf)  # noqa: E731
                elif samples is not None:
                    samples.append(x)
                    ci_fn = lambda conf, _t: sign_test_median_ci(  # noqa: E731
                        samples, conf)
                ctx = EvalContext(welford=state,
                                  elapsed_s=self.clock() - t0,
                                  count=count,
                                  incumbent=_resolve_incumbent(incumbent),
                                  direction=self.settings.direction,
                                  ci_fn=ci_fn)
                decision = first_decision(conditions, ctx)
            if decision is not None:
                break
        return InvocationResult(mean=float(state.mean), count=count,
                                elapsed_s=self.clock() - t0,
                                stop_reason=decision.reason,
                                pruned=decision.pruned,
                                m2=float(state.m2))

    # -- outer loop -----------------------------------------------------------
    def evaluate(self, make_invocation: InvocationFactory,
                 incumbent: Incumbent = None) -> EvalResult:
        s = self.settings
        inner_conds = s.inner_conditions()
        outer_conds = s.outer_conditions()
        outer_state = welford.init()
        invocations: list[InvocationResult] = []
        pruned = False
        t_start = self.clock()
        measured = 0.0
        decision: Optional[StopDecision] = None
        direction = s.direction
        best_inv: Optional[float] = None
        while True:
            with trace_span("invocation", cat="invocation",
                            n=len(invocations) + 1) as ispan:
                with phase("setup"):
                    sample_fn = make_invocation()
                inv = self._run_invocation(sample_fn, incumbent,
                                           inner_conds)
                ispan.set(mean=inv.mean, count=inv.count,
                          stop_reason=inv.stop_reason, pruned=inv.pruned)
            invocations.append(inv)
            measured += inv.elapsed_s
            pruned = pruned or inv.pruned
            outer_state = welford.update(outer_state, inv.mean)
            if best_inv is None or direction.better(inv.mean, best_inv):
                best_inv = inv.mean
            ctx = EvalContext(welford=outer_state,
                              elapsed_s=self.clock() - t_start,
                              count=len(invocations),
                              incumbent=_resolve_incumbent(incumbent),
                              direction=direction)
            decision = first_decision(outer_conds, ctx)
            if decision is not None:
                pruned = pruned or decision.pruned
                break
            # An inner prune means this configuration cannot win; there is no
            # value in further invocations of a doomed configuration.
            if inv.pruned:
                decision = StopDecision(reason="inner_pruned", pruned=True)
                break
        if s.device_timing and not pruned:
            self._device_profile(sample_fn, float(outer_state.mean),
                                 incumbent, direction)
        return EvalResult(score=float(outer_state.mean),
                          best_invocation=float(best_inv),
                          invocations=tuple(invocations),
                          total_samples=sum(i.count for i in invocations),
                          total_time_s=self.clock() - t_start,
                          measured_time_s=measured,
                          pruned=pruned,
                          stop_reason=decision.reason)

    # -- on-device timing -----------------------------------------------------
    def _device_profile(self, sample_fn: Callable[[], float], score: float,
                        incumbent: Incumbent, direction: Direction) -> None:
        """One extra profiled sample for incumbent-candidate trials.

        Only runs when a trace recorder is installed (the result is a
        trace attribute, nothing else consumes it) and only for scores
        that beat the current incumbent — profiling slows the profiled
        call, so doomed configurations never pay for it. ``None`` from the
        profiler (host-only work) becomes a ``device_timing_unavailable``
        instant; a :class:`~repro_torch.obs.device_timing.DeviceTimingError`
        (kernels launched, none recorded) propagates.
        """
        if trace_sink() is None:
            return
        inc = _resolve_incumbent(incumbent)
        if inc is not None and not direction.better(score, inc):
            return
        from ..obs.device_timing import profile_sample
        timing = profile_sample(sample_fn)
        if timing is None:
            trace_instant("device_timing_unavailable")
        else:
            trace_instant("device_timing", **timing.to_json())


class TimingResolutionWarning(UserWarning):
    """A timed sample landed under 10x the clock's resolution.

    At that scale quantization error alone is >10% of the reading — the
    observation is noise, not measurement. Switch to ``steady_sampler``
    (batch B calls per observation) or grow the per-call workload.
    """


@dataclasses.dataclass(frozen=True)
class ClockCalibration:
    """Measured properties of a clock callable.

    ``resolution_s`` — smallest positive delta two consecutive readings
    can differ by (timer quantum). ``overhead_s`` — mean cost of one
    ``clock()`` call, which a t0/t1 bracket adds to every sample.
    """

    resolution_s: float
    overhead_s: float


_CLOCK_CALIBRATION: Optional[ClockCalibration] = None


def calibrate_clock(clock: Callable[[], float] = time.perf_counter,
                    samples: int = 4096) -> ClockCalibration:
    """Measure a clock's resolution and per-call overhead.

    The default ``time.perf_counter`` is calibrated once per process and
    cached; custom clocks are measured fresh on every call (tests pass
    deterministic fake clocks that must not be consumed by calibration
    — samplers only auto-calibrate the default clock).
    """
    global _CLOCK_CALIBRATION
    is_default = clock is time.perf_counter
    if is_default and _CLOCK_CALIBRATION is not None:
        return _CLOCK_CALIBRATION
    # Overhead: time a tight loop of clock() calls.
    t0 = clock()
    for _ in range(samples):
        clock()
    overhead = (clock() - t0) / (samples + 1)
    # Resolution: smallest positive delta seen across consecutive reads.
    resolution = float("inf")
    prev = clock()
    for _ in range(samples):
        cur = clock()
        d = cur - prev
        if 0.0 < d < resolution:
            resolution = d
        prev = cur
    if resolution == float("inf"):    # clock never advanced
        resolution = 0.0
    cal = ClockCalibration(resolution_s=resolution, overhead_s=overhead)
    if is_default:
        _CLOCK_CALIBRATION = cal
    return cal


def timed_sampler(fn: Callable[[], None], work: float,
                  clock: Callable[[], float] = time.perf_counter,
                  calibration: Optional[ClockCalibration] = None,
                  *, card_clock: Optional["CardClock"] = None,
                  ) -> Callable[[], float]:
    """Wrap a side-effecting callable into a metric sampler.

    Returns a sampler yielding ``work / elapsed`` per call — e.g. FLOPs/s when
    ``work`` is the FLOP count of one call, or bytes/s for bandwidth
    benchmarks. This is the paper's gettimeofday-around-the-BLAS-call pattern.

    The default clock is calibrated once per process: its per-call
    overhead is subtracted from every reading, and a sample landing
    under 10x the clock's resolution raises a one-shot
    :class:`TimingResolutionWarning` instead of silently reporting a
    quantization-noise throughput. Custom clocks are taken at face value
    unless an explicit ``calibration`` is passed.

    With a :class:`~repro_torch.core.card_clock.CardClock` the elapsed
    time is the card's: ``fn`` then only queues its work, and the clock
    brackets it with CUDA events and synchronizes once (the host bracket
    still lands in the ``dispatch`` phase).
    """
    if card_clock is not None:
        def card_sample() -> float:
            t0 = clock()
            dt = card_clock.measure(fn)
            t1 = clock()
            record_phase("dispatch", t1 - t0,
                         at=t1 if clock is time.perf_counter else None)
            return work / dt

        return card_sample
    if calibration is None and clock is time.perf_counter:
        calibration = calibrate_clock(clock)
    overhead = calibration.overhead_s if calibration else 0.0
    resolution = calibration.resolution_s if calibration else 0.0
    floor = resolution if resolution > 0.0 else 1e-12
    warned = [False]
    # clock readings only mark trace positions when they share the
    # recorder's clock; fake test clocks fall back to "now"
    default_clock = clock is time.perf_counter

    def sample() -> float:
        t0 = clock()
        fn()
        t1 = clock()
        dt = t1 - t0 - overhead
        if dt < 10.0 * resolution and not warned[0]:
            warned[0] = True
            warnings.warn(
                f"timed sample ({dt:.3g}s) is under 10x the clock "
                f"resolution ({resolution:.3g}s); use steady_sampler or a "
                f"larger per-call workload", TimingResolutionWarning,
                stacklevel=2)
        dt = max(dt, floor)
        record_phase("dispatch", t1 - t0,
                     at=t1 if default_clock else None)
        return work / dt

    return sample


@dataclasses.dataclass(frozen=True)
class BatchCalibration:
    """Fitted dispatch-batch timing model ``t(B) = overhead + B * t_exec``.

    ``batch`` is the smallest B keeping the fixed per-observation
    overhead (clock bracket + final sync + queue ramp) under the
    requested fraction of useful kernel time.
    """

    batch: int
    t_exec_s: float
    overhead_s: float


def calibrate_batch(dispatch: Callable[[], Any],
                    sync: Callable[[Any], None], *,
                    clock: Callable[[], float] = time.perf_counter,
                    overhead_frac: float = 0.02,
                    max_batch: int = 1024,
                    probe: int = 8) -> BatchCalibration:
    """Choose the dispatch batch size B for :func:`steady_sampler`.

    Times one synced call and one ``probe``-deep batch, fits
    ``t(B) = overhead + B * t_exec``, and returns the smallest B with
    ``overhead / (B * t_exec) <= overhead_frac``. Costs ``2 + probe + 3``
    kernel executions — calibrate once per workload and share the result
    across invocations (``steady_sampler(..., batch=cal.batch)``).
    """
    if probe < 2:
        raise ValueError(f"probe must be >= 2, got {probe}")
    sync(dispatch())               # warm: compile + allocator + queue
    sync(dispatch())
    singles = []
    for _ in range(3):
        t0 = clock()
        sync(dispatch())
        singles.append(clock() - t0)
    t1 = sorted(singles)[1]        # median of 3
    t0 = clock()
    h = None
    for _ in range(probe):
        h = dispatch()
    sync(h)
    tb = clock() - t0
    t_exec = max((tb - t1) / (probe - 1), 1e-12)
    overhead = max(t1 - t_exec, 0.0)
    batch = max(1, min(max_batch,
                       -(-overhead // (overhead_frac * t_exec))))
    return BatchCalibration(batch=int(batch), t_exec_s=t_exec,
                            overhead_s=overhead)


def steady_sampler(dispatch: Callable[[], Any], work: float, *,
                   sync: Callable[[Any], None],
                   batch: Optional[int] = None,
                   clock: Callable[[], float] = time.perf_counter,
                   overhead_frac: float = 0.02,
                   max_batch: int = 1024,
                   calibration: Optional[ClockCalibration] = None,
                   card_clock: Optional["CardClock"] = None,
                   ) -> Callable[[], float]:
    """Batched low-overhead sampler: B async dispatches, one sync.

    ``dispatch`` enqueues one kernel execution without blocking and
    returns a handle (the launch's output tensor); ``sync`` blocks until
    the handle's work is done (on a card, ``torch.cuda.synchronize``).
    Each observation enqueues B dispatches
    back-to-back, syncs once, and reports ``work * B / elapsed`` — the
    per-sample clock + sync overhead is amortized over B and the device
    queue stays full between calls ("steady state" dispatch).

    ``batch=None`` auto-calibrates B via :func:`calibrate_batch` so the
    fixed overhead stays under ``overhead_frac`` of kernel time; the
    chosen B is exposed as ``sample.batch``. Calibration costs ~13
    kernel executions, so share an explicit ``batch`` across invocations
    of the same workload.

    Welford/CI semantics with B > 1: each observation is the *mean
    throughput of a B-call batch*, so downstream confidence intervals
    quantify run-to-run variation of batch means — per-call variance is
    averaged down by ~B inside each observation and CIConverged
    typically triggers sooner. Scores remain estimates of the same mean
    rate.

    With a :class:`~repro_torch.core.card_clock.CardClock` each
    observation is the card's time of the B queued dispatches; the host's
    queueing and the clock's synchronize land in the ``dispatch`` and
    ``sync`` phases.
    """
    if batch is None:
        bcal = calibrate_batch(dispatch, sync, clock=clock,
                               overhead_frac=overhead_frac,
                               max_batch=max_batch)
        batch = bcal.batch
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if calibration is None and clock is time.perf_counter:
        calibration = calibrate_clock(clock)
    clock_overhead = 2.0 * calibration.overhead_s if calibration else 0.0
    total_work = work * batch
    b = batch
    default_clock = clock is time.perf_counter

    def enqueue() -> None:
        for _ in range(b):
            dispatch()

    def card_sample() -> float:
        t0 = clock()
        dt = card_clock.measure(enqueue)
        t1 = clock()
        record_phase("dispatch", card_clock.queued_s)
        record_phase("sync", max(t1 - t0 - card_clock.queued_s, 0.0),
                     at=t1 if default_clock else None)
        return total_work / dt

    def sample() -> float:
        t0 = clock()
        h = None
        for _ in range(b):
            h = dispatch()
        tm = clock()
        sync(h)
        t1 = clock()
        dt = max(t1 - t0 - clock_overhead, 1e-12)
        record_phase("dispatch", tm - t0,
                     at=tm if default_clock else None)
        record_phase("sync", t1 - tm,
                     at=t1 if default_clock else None)
        return total_work / dt

    if card_clock is not None:
        sample = card_sample
    sample.batch = batch
    return sample
