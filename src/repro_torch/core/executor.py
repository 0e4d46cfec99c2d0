"""Pluggable execution backends for the autotuner.

The paper's search loop is inherently serial: one configuration at a time,
each pruned against the incumbent best found so far (stop condition 4).
This module factors the *scheduling* of configuration evaluations out of
:class:`~repro_torch.core.tuner.Tuner` so the same search semantics run
under more than one execution regime:

  * :class:`SerialBackend` — the paper's semantics, one evaluation at a
    time.
  * :class:`ThreadPoolBackend` — configurations evaluate concurrently;
    every evaluation reads the incumbent from a lock-protected
    :class:`IncumbentCell` *per sample*, so stop-condition-4 pruning works
    against the live global best rather than a stale snapshot. Real
    benchmarks block on device synchronisation
    (``torch.cuda.synchronize`` releases the GIL), so threads overlap
    genuinely on hardware.

The JAX package's round-synchronized backends (the simulated fleet and
the spawn-only process pool) are not ported yet.

Backends consume *batches* — the unit a
:class:`~repro_torch.core.strategy.SearchStrategy` proposes via ``ask()``
— not a flat configuration list. A :class:`Batch` carries its
configurations plus an optional per-batch
:class:`~repro_torch.core.evaluator.EvaluationSettings` override
(successive halving raises the iteration budget per rung this way), and
the strategy's ``tell()`` is guaranteed to have seen every outcome of a
batch before the next ``ask()``.

Backends receive an ``evaluate(config, incumbent, settings)`` callable
(built by the tuner; it owns the evaluator) where ``incumbent`` may be a
float, ``None``, or a zero-arg callable yielding the live best score, and
``settings`` is the batch override (``None`` — use the tuner's own). A
flat ``Sequence[Config]`` is still accepted by :meth:`ExecutionBackend.run`
and coerced to one batch.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Mapping, Optional, Sequence, Union

from .evaluator import EvalResult, EvaluationSettings, Incumbent
from .profiling import trace_instant, trace_span
from .searchspace import Config
from .stop_conditions import Direction

__all__ = ["Batch", "BatchStats", "ExecutionBackend", "ExecutionStats",
           "IncumbentCell", "SerialBackend", "ThreadPoolBackend",
           "TrialOutcome"]

# (config, incumbent, batch settings override) -> EvalResult; see
# evaluator.Incumbent for the float-or-live-supplier contract
EvaluateFn = Callable[[Config, Incumbent, Optional[EvaluationSettings]],
                      EvalResult]
ProgressFn = Callable[[Config, EvalResult], None]
#: batch-end feedback, called once per outcome in proposal order on the
#: scheduling thread (strategy tell + trial recording)
ObserveFn = Callable[["TrialOutcome"], None]
#: immediate persistence hook, called as soon as an outcome exists — from
#: the worker thread on concurrent backends, so it must be thread-safe
#: (TrialCache.put is); a killed run loses at most the trials in flight
PersistFn = Callable[["TrialOutcome"], None]


class IncumbentCell:
    """Lock-protected live best (score, config) shared across workers.

    ``offer`` folds a finished evaluation in; ``get`` is safe to call from
    inside a running evaluation (it is the pruning reference), so the cell
    is the single synchronization point between concurrent trials.
    """

    def __init__(self, direction: Direction,
                 score: Optional[float] = None,
                 config: Optional[Config] = None):
        self._lock = threading.Lock()
        self.direction = direction
        self._score = score
        self._config = config
        self._history: list[tuple[Optional[Config], float]] = []
        if score is not None:
            self._history.append((config, score))

    def get(self) -> Optional[float]:
        with self._lock:
            return self._score

    def snapshot(self) -> tuple[Optional[Config], Optional[float]]:
        with self._lock:
            return self._config, self._score

    def history(self) -> tuple[tuple[Optional[Config], float], ...]:
        """Every accepted incumbent in acceptance order (a warm-start seed,
        if any, is entry 0) — the convergence trajectory reports print."""
        with self._lock:
            return tuple(self._history)

    def offer(self, config: Config, score: float) -> bool:
        """Fold in a candidate; returns True iff it became the incumbent."""
        with self._lock:
            if self._score is None or self.direction.better(score,
                                                            self._score):
                self._score = score
                self._config = config
                self._history.append((config, score))
                return True
            return False


@dataclasses.dataclass(frozen=True)
class Batch:
    """One strategy proposal: configurations to evaluate together.

    ``settings`` overrides the tuner's evaluation settings for this batch
    only (e.g. a successive-halving rung budget); ``None`` means the
    tuner's own settings apply — and only then may the trial cache serve
    hits, since cached results were measured under those settings.
    """

    configs: tuple[Config, ...]
    settings: Optional[EvaluationSettings] = None

    def __len__(self) -> int:
        return len(self.configs)


@dataclasses.dataclass(frozen=True)
class TrialOutcome:
    """One scheduled evaluation as the backend saw it."""

    index: int           # position in the overall proposal order
    config: Config
    result: EvalResult
    worker: int = 0
    elapsed_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class BatchStats:
    """Per-batch scheduling accounting (one strategy round)."""

    index: int
    size: int
    wall_s: float
    n_pruned: int


@dataclasses.dataclass(frozen=True)
class ExecutionStats:
    """Scheduling accounting, uniform across backends."""

    backend: str
    n_workers: int
    serial_time_s: float     # sum of per-trial wall clock
    parallel_time_s: float   # run wall clock (simulated: max over workers)
    batches: tuple[BatchStats, ...] = ()


BatchSource = Union[Iterable[Batch], Sequence[Config]]


def _traced_trial(clock: Callable[[], float], evaluate: EvaluateFn,
                  cfg: Config, incumbent: Incumbent,
                  settings: Optional[EvaluationSettings],
                  cell: Optional[IncumbentCell], index: int, worker: int,
                  ) -> tuple[EvalResult, float]:
    """Evaluate one configuration inside a ``cat="trial"`` trace span.

    Runs on the thread that executes the trial, so the span lands on the
    right tid with the evaluator's invocation/phase spans nested inside.
    ``cell`` non-None folds the score into the live incumbent (serial and
    thread backends); round-synchronized backends pass ``None`` and
    all-reduce at the round end, emitting their improvement instants
    there instead.
    """
    with trace_span("trial", cat="trial", index=index,
                    config=dict(cfg)) as span:
        t1 = clock()
        res = evaluate(cfg, incumbent, settings)
        dt = clock() - t1
        improved = False
        if res.pruned:
            trace_instant("trial_pruned", reason=res.stop_reason)
        elif cell is not None:
            improved = cell.offer(cfg, res.score)
            if improved:
                trace_instant("incumbent_improved", score=res.score)
        span.set(score=res.score, pruned=res.pruned,
                 stop_reason=res.stop_reason, samples=res.total_samples,
                 worker=worker, improved=improved)
    return res, dt


class ExecutionBackend:
    """Schedules evaluations over strategy-proposed batches.

    Subclasses implement :meth:`_run_batch` (execute one batch, calling
    ``observe`` for every outcome before returning — that ordering is what
    guarantees a strategy's ``tell()`` runs before its next ``ask()``) and
    may override the per-run context hooks for pools or per-worker
    accounting. ``batch_hint`` is the batch size the backend schedules
    best (its parallel width); strategies treat it as a suggestion.
    """

    name: str = "base"
    n_workers: int = 1
    #: round width passed to ``SearchStrategy.ask``: the all-reduce batch
    #: size for round-synchronized backends (simulated, process), ``None``
    #: when the backend imposes no round structure (serial, thread) — the
    #: strategy then proposes its full natural unit per batch
    batch_hint: Optional[int] = None
    #: chunk size used when a flat config list is passed to :meth:`run`
    #: (``None`` — a single batch, the pre-strategy behaviour of the
    #: serial/thread backends; round-synchronized backends use n_workers)
    legacy_round: Optional[int] = None
    clock: Callable[[], float] = staticmethod(time.perf_counter)

    def run(self, batches: BatchSource, evaluate: EvaluateFn,
            cell: IncumbentCell, progress: Optional[ProgressFn] = None,
            observe: Optional[ObserveFn] = None,
            persist: Optional[PersistFn] = None,
            ) -> tuple[list[TrialOutcome], ExecutionStats]:
        """Drain ``batches`` (an iterable of :class:`Batch`, typically a
        generator pulling from a strategy, or a flat config list for
        compatibility) and return every outcome plus scheduling stats."""
        batches = self._as_batches(batches)
        outcomes: list[TrialOutcome] = []
        stats: list[BatchStats] = []
        serial = 0.0
        t0 = self.clock()
        ctx = self._start_run()
        try:
            for b, batch in enumerate(batches):
                if not batch.configs:
                    continue
                tb = self.clock()
                got = self._run_batch(ctx, batch, evaluate, cell, progress,
                                      observe, persist,
                                      base_index=len(outcomes))
                outcomes.extend(got)
                serial += sum(o.elapsed_s for o in got)
                stats.append(BatchStats(
                    index=b, size=len(got), wall_s=self.clock() - tb,
                    n_pruned=sum(1 for o in got if o.result.pruned)))
        finally:
            self._end_run(ctx)
        wall = self.clock() - t0
        return outcomes, ExecutionStats(
            backend=self.name, n_workers=self.n_workers,
            serial_time_s=serial,
            parallel_time_s=self._parallel_time(ctx, wall),
            batches=tuple(stats))

    # -- per-run hooks --------------------------------------------------------
    def _start_run(self):
        return None

    def _end_run(self, ctx) -> None:
        pass

    def _parallel_time(self, ctx, wall: float) -> float:
        return wall

    def _run_batch(self, ctx, batch: Batch, evaluate: EvaluateFn,
                   cell: IncumbentCell, progress: Optional[ProgressFn],
                   observe: Optional[ObserveFn],
                   persist: Optional[PersistFn],
                   base_index: int) -> list[TrialOutcome]:
        raise NotImplementedError

    # -- compatibility --------------------------------------------------------
    def _as_batches(self, batches: BatchSource) -> Iterable[Batch]:
        """Coerce a flat ``Sequence[Config]`` into this backend's
        pre-strategy batching (one batch, or ``legacy_round``-sized rounds
        for the round-synchronized backends)."""
        if isinstance(batches, Sequence) and not isinstance(batches,
                                                            (str, bytes)):
            items = list(batches)
            if items and all(isinstance(c, Mapping) for c in items):
                size = self.legacy_round or len(items)
                return [Batch(tuple(items[i:i + size]))
                        for i in range(0, len(items), size)]
        return batches


class SerialBackend(ExecutionBackend):
    """One evaluation at a time, in proposal order (the paper's loop)."""

    name = "serial"

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock

    def _run_batch(self, ctx, batch, evaluate, cell, progress, observe,
                   persist, base_index):
        outcomes: list[TrialOutcome] = []
        for j, cfg in enumerate(batch.configs):
            res, dt = _traced_trial(self.clock, evaluate, cfg, cell.get,
                                    batch.settings, cell, base_index + j,
                                    worker=0)
            out = TrialOutcome(index=base_index + j, config=cfg, result=res,
                               elapsed_s=dt)
            outcomes.append(out)
            # persist + observe before progress, so a progress callback
            # that aborts the run never loses the trial
            if persist is not None:
                persist(out)
            if observe is not None:
                observe(out)
            if progress is not None:
                progress(cfg, res)
        return outcomes


class ThreadPoolBackend(ExecutionBackend):
    """Concurrent evaluations sharing the incumbent cell live.

    Each in-flight evaluation re-reads the cell before every sample, so a
    best score found on one thread immediately tightens stop-condition-4
    pruning on all others. ``persist`` and ``progress`` fire live from
    the worker thread as each trial finishes (so a killed run keeps every
    completed trial on disk); ``observe`` runs on the scheduling thread
    at the batch end, in proposal order.
    """

    name = "thread"

    def __init__(self, n_workers: int = 4,
                 clock: Callable[[], float] = time.perf_counter):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.n_workers = n_workers
        self.clock = clock

    def _start_run(self):
        return {"pool": ThreadPoolExecutor(max_workers=self.n_workers),
                "progress_lock": threading.Lock()}

    def _end_run(self, ctx) -> None:
        ctx["pool"].shutdown(wait=True)

    def _run_batch(self, ctx, batch, evaluate, cell, progress, observe,
                   persist, base_index):
        lock = ctx["progress_lock"]

        def work(j: int, cfg: Config) -> TrialOutcome:
            res, dt = _traced_trial(self.clock, evaluate, cfg, cell.get,
                                    batch.settings, cell, base_index + j,
                                    worker=j % self.n_workers)
            out = TrialOutcome(index=base_index + j, config=cfg, result=res,
                               elapsed_s=dt)
            if persist is not None:
                persist(out)          # thread-safe; survives a killed run
            if progress is not None:
                with lock:
                    progress(cfg, res)
            return out

        outcomes = list(ctx["pool"].map(work, range(len(batch.configs)),
                                        batch.configs))
        if observe is not None:
            for out in outcomes:
                observe(out)
        return outcomes
