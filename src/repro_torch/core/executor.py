"""Pluggable execution backends for the autotuner.

The paper's search loop is inherently serial: one configuration at a time,
each pruned against the incumbent best found so far (stop condition 4).
This module factors the *scheduling* of configuration evaluations out of
:class:`~repro_torch.core.tuner.Tuner` so the same search semantics run
under four execution regimes:

  * :class:`SerialBackend` — the paper's semantics, one evaluation at a
    time.
  * :class:`ThreadPoolBackend` — configurations evaluate concurrently;
    every evaluation reads the incumbent from a lock-protected
    :class:`IncumbentCell` *per sample*, so stop-condition-4 pruning works
    against the live global best rather than a stale snapshot. Real
    benchmarks block on device synchronisation
    (``torch.cuda.synchronize`` releases the GIL), so threads overlap
    genuinely on hardware.
  * :class:`ProcessPoolBackend` — configurations evaluate in worker
    *processes* (started by ``spawn``: CUDA breaks under fork), escaping
    the GIL for host-bound objectives. The evaluate callable and the
    benchmark must be picklable; the incumbent is frozen per batch
    (cross-process live sharing would serialize on IPC), so batch
    boundaries are this backend's all-reduce rounds, exactly like the
    simulated fleet.
  * :class:`SimulatedShardedBackend` — a simulated fleet: one
    synchronized round per batch, incumbent all-reduced between rounds,
    faithful per-worker wall-clock accounting (parallel time = max over
    workers).

Backends consume *batches* — the unit a
:class:`~repro_torch.core.strategy.SearchStrategy` proposes via ``ask()``
— not a flat configuration list. A :class:`Batch` carries its
configurations plus an optional per-batch
:class:`~repro_torch.core.evaluator.EvaluationSettings` override
(successive halving raises the iteration budget per rung this way).
Batch boundaries are semantic: round-synchronized backends (simulated,
process) freeze the incumbent per batch and all-reduce at the batch end,
and the strategy's ``tell()`` is guaranteed to have seen every outcome of
a batch before the next ``ask()``.

Backends receive an ``evaluate(config, incumbent, settings)`` callable
(built by the tuner; it owns the evaluator) where ``incumbent`` may be a
float, ``None``, or a zero-arg callable yielding the live best score, and
``settings`` is the batch override (``None`` — use the tuner's own). A
flat ``Sequence[Config]`` is still accepted by :meth:`ExecutionBackend.run`
and coerced to batches reproducing each backend's pre-strategy behaviour
(one batch, or ``n_workers``-sized rounds on the round-synchronized
backends).
"""

from __future__ import annotations

import dataclasses
import pickle
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Iterable, Mapping, Optional, Sequence, Union

from .evaluator import EvalResult, EvaluationSettings, Incumbent
from .profiling import trace_instant, trace_span
from .searchspace import Config
from .stop_conditions import Direction

__all__ = ["Batch", "BatchStats", "ExecutionBackend", "ExecutionStats",
           "IncumbentCell", "ProcessPoolBackend", "SerialBackend",
           "SimulatedShardedBackend", "ThreadPoolBackend", "TrialOutcome"]

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


def shard_configs(configs: Sequence[Config],
                  n_workers: int) -> list[list[Config]]:
    """Strided assignment: adjacent (similar-cost) configs spread across
    workers, balancing the size-correlated evaluation cost (paper Fig. 6)."""
    configs = list(configs)
    return [configs[w::n_workers] for w in range(n_workers)]


class SimulatedShardedBackend(ExecutionBackend):
    """Simulated fleet: one synchronized round per batch.

    Workers run lockstep rounds; within a round every worker prunes against
    the incumbent agreed at the end of the *previous* round (a scalar
    ``all_reduce`` with ``MAX``/``MIN`` on a real process group). Evaluations execute serially
    here but per-worker wall clock is accounted faithfully, so
    ``parallel_time_s`` is the simulated fleet wall clock. Batch boundaries
    are the all-reduce rounds: a flat config list is coerced to
    ``n_workers``-sized rounds, reproducing the pre-strategy strided
    schedule exactly.
    """

    name = "simulated"

    def __init__(self, n_workers: int = 4,
                 clock: Callable[[], float] = time.perf_counter):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.n_workers = n_workers
        self.batch_hint = n_workers
        self.legacy_round = n_workers
        self.clock = clock

    def _start_run(self):
        return {"worker_time": [0.0] * self.n_workers}

    def _parallel_time(self, ctx, wall: float) -> float:
        times = ctx["worker_time"]
        return max(times) if any(t > 0.0 for t in times) else 0.0

    def _run_batch(self, ctx, batch, evaluate, cell, progress, observe,
                   persist, base_index):
        frozen = cell.get()  # previous round's all-reduced incumbent
        outcomes: list[TrialOutcome] = []
        for j, cfg in enumerate(batch.configs):
            w = j % self.n_workers
            res, dt = _traced_trial(self.clock, evaluate, cfg, frozen,
                                    batch.settings, None, base_index + j,
                                    worker=w)
            ctx["worker_time"][w] += dt
            out = TrialOutcome(index=base_index + j, config=cfg,
                               result=res, worker=w, elapsed_s=dt)
            outcomes.append(out)
            if persist is not None:
                persist(out)
            if progress is not None:
                progress(cfg, res)
        for out in outcomes:            # the round's all-reduce
            if not out.result.pruned and cell.offer(out.config,
                                                    out.result.score):
                trace_instant("incumbent_improved",
                              score=out.result.score, trial=out.index)
        if observe is not None:
            for out in outcomes:
                observe(out)
        return outcomes


def _process_trial(evaluate: EvaluateFn, cfg: Config,
                   incumbent: Optional[float],
                   settings: Optional[EvaluationSettings],
                   ) -> tuple[EvalResult, float]:
    """Worker-side trial: runs in the pool process; the elapsed time is
    measured inside the worker so IPC overhead never pollutes trial time."""
    t1 = time.perf_counter()
    res = evaluate(cfg, incumbent, settings)
    return res, time.perf_counter() - t1


class ProcessPoolBackend(ExecutionBackend):
    """Evaluations in worker processes — escapes the GIL for CPU-bound
    objectives (the ROADMAP's process-pool backend).

    The evaluate callable (and therefore the benchmark factory and
    settings) must be picklable; module-level functions qualify, lambdas
    and closures do not — :meth:`run` raises a ``TypeError`` naming the
    offender up front rather than failing inside the pool. The incumbent
    is frozen per batch and all-reduced at the batch end (live
    cross-process sharing would serialize every sample on IPC), so this
    backend has the simulated fleet's round semantics with real
    parallelism.

    Workers start via the ``spawn`` method by default: CUDA cannot be
    re-initialized in a forked child of a process that has already
    initialized it. Spawned workers re-import the evaluate task's modules
    (the parent's ``sys.path`` is inherited) and each opens its own CUDA
    context, costing seconds of startup per pool — amortized over a
    search. The hand kernels' library is built once per source tree:
    ``repro_torch.kernels.build`` takes a file lock, so workers reaching a
    cold build together compile it once. Pass ``start_method="fork"``
    only for objectives that never touch CUDA.
    """

    name = "process"

    def __init__(self, n_workers: int = 4,
                 clock: Callable[[], float] = time.perf_counter,
                 start_method: str = "spawn"):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.n_workers = n_workers
        self.batch_hint = n_workers
        self.legacy_round = n_workers
        self.clock = clock
        self.start_method = start_method

    def _make_pool(self) -> ProcessPoolExecutor:
        import multiprocessing
        try:
            mp_ctx = multiprocessing.get_context(self.start_method)
        except ValueError:                       # platform without it
            mp_ctx = multiprocessing.get_context()
        return ProcessPoolExecutor(max_workers=self.n_workers,
                                   mp_context=mp_ctx)

    def _start_run(self):
        return {"pool": None, "checked": False}

    def _end_run(self, ctx) -> None:
        if ctx["pool"] is not None:
            ctx["pool"].shutdown(wait=True)

    def _check_picklable(self, evaluate: EvaluateFn,
                         settings: Optional[EvaluationSettings]) -> None:
        try:
            pickle.dumps((evaluate, settings))
        except Exception as e:
            raise TypeError(
                "ProcessPoolBackend requires a picklable evaluate task: "
                "benchmark factories must be module-level callables, not "
                f"lambdas or closures ({e})") from e

    def _run_batch(self, ctx, batch, evaluate, cell, progress, observe,
                   persist, base_index):
        if not ctx["checked"]:
            self._check_picklable(evaluate, batch.settings)
            ctx["checked"] = True
        if ctx["pool"] is None:
            ctx["pool"] = self._make_pool()
        frozen = cell.get()  # previous batch's all-reduced incumbent
        futures = [ctx["pool"].submit(_process_trial, evaluate, cfg, frozen,
                                      batch.settings)
                   for cfg in batch.configs]
        outcomes: list[TrialOutcome] = []
        for j, (cfg, fut) in enumerate(zip(batch.configs, futures)):
            res, dt = fut.result()
            out = TrialOutcome(index=base_index + j, config=cfg, result=res,
                               worker=j % self.n_workers, elapsed_s=dt)
            outcomes.append(out)
            # worker processes carry no recorder, so trials surface as
            # parent-side instants (timing measured inside the worker)
            trace_instant("trial_completed", index=out.index,
                          score=res.score, pruned=res.pruned,
                          worker=out.worker, elapsed_s=dt)
            if persist is not None:     # parent-side, as futures land
                persist(out)
        for out in outcomes:            # the batch's all-reduce
            if not out.result.pruned and cell.offer(out.config,
                                                    out.result.score):
                trace_instant("incumbent_improved",
                              score=out.result.score, trial=out.index)
        for out in outcomes:
            if observe is not None:
                observe(out)
            if progress is not None:
                progress(out.config, out.result)
        return outcomes
