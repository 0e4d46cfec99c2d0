"""The autotuner engine: strategy-proposed, CI-pruned evaluation (paper
Fig. 2, generalized).

A :class:`~repro_torch.core.strategy.SearchStrategy` proposes configuration
batches (``ask``), an :class:`~repro_torch.core.executor.ExecutionBackend`
schedules their evaluation through the two-level
:class:`~repro_torch.core.evaluator.Evaluator`, and every outcome is fed back
(``tell``) before the next proposal — with the incumbent best shared
through a lock-protected cell so stop condition 4 prunes doomed
configurations against the live (or round-frozen) global best. The
paper's experiments (Tables VIII-XI) are exactly runs of this engine
under the exhaustive strategy with different
:class:`EvaluationSettings` flags and search orders.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

from ..obs.metrics import metrics as obs_metrics
from .evaluator import (EvalResult, EvaluationSettings, Evaluator, Incumbent,
                        InvocationFactory)
from .exec_cache import CompilePipeline, default_cache
from .executor import (Batch, BatchStats, ExecutionBackend, IncumbentCell,
                       SerialBackend, TrialOutcome)
from .profiling import phase, trace_instant, trace_sink, trace_span
from .searchspace import Config, SearchSpace
from .strategy import ExhaustiveStrategy, SearchStrategy, SuccessiveHalvingStrategy

__all__ = ["BenchmarkFactory", "EvaluateTask", "TrialRecord", "Tuner",
           "TuningResult", "compare_techniques", "standard_techniques",
           "tune_successive_halving"]

# A benchmark binds a configuration to a per-invocation sampler factory.
BenchmarkFactory = Callable[[Config], InvocationFactory]


@dataclasses.dataclass(frozen=True)
class TrialRecord:
    config: Config
    result: EvalResult
    cached: bool = False      # served from a TrialCache, not re-evaluated
    worker: int = 0           # backend worker that ran it


@dataclasses.dataclass
class EvaluateTask:
    """The engine's evaluation callable, shipped to backends.

    A plain dataclass (not a closure) so a process-pool backend can
    pickle it into worker processes — which also requires ``benchmark`` to
    be picklable. The optional per-call ``settings`` is a
    strategy's batch override (e.g. a successive-halving rung budget).
    """

    settings: EvaluationSettings
    benchmark: BenchmarkFactory
    clock: Callable[[], float] = time.perf_counter

    def __call__(self, config: Config, incumbent: Incumbent,
                 settings: Optional[EvaluationSettings] = None) -> EvalResult:
        obs_metrics().inc("trials.started")
        evaluator = Evaluator(settings or self.settings, clock=self.clock)
        return evaluator.evaluate(self.benchmark(config), incumbent=incumbent)


@dataclasses.dataclass(frozen=True)
class TuningResult:
    best_config: Optional[Config]
    best_score: Optional[float]
    trials: tuple[TrialRecord, ...]
    total_time_s: float
    total_samples: int
    n_pruned: int
    settings_label: str
    order: str
    # execution-backend accounting (serial defaults keep old pickles/tests)
    backend: str = "serial"
    n_workers: int = 1
    serial_time_s: float = 0.0     # sum of per-trial wall clock
    parallel_time_s: float = 0.0   # run wall clock (simulated: max/worker)
    n_cached: int = 0              # trials served from the cache
    # incumbent trajectory: every accepted (config, score) in acceptance
    # order; entry 0 is the warm-start seed when a cache seeded the cell
    improvements: tuple[tuple[Optional[Config], float], ...] = ()
    # strategy accounting
    strategy: str = "exhaustive"   # SearchStrategy.name that drove the run
    batches: tuple[BatchStats, ...] = ()   # one entry per strategy round
    n_seeded: int = 0              # transfer seeds injected into the search
    n_precompiled: int = 0         # executables compiled by the pipeline
    # observability: the session's trace file (None when
    # tracing was off), the per-session MetricsRegistry delta, and the
    # per-session ExecCacheStats delta of the shared process cache —
    # deltas, so back-to-back sessions never report each other's counts
    trace_path: Optional[str] = None
    metrics: Optional[dict] = None
    exec_cache: Optional[dict] = None

    def summary_row(self) -> dict:
        return {
            "technique": self.settings_label + ("+R" if self.order == "reverse" else ""),
            "best_score": self.best_score,
            "best_config": self.best_config,
            "time_s": round(self.total_time_s, 4),
            "samples": self.total_samples,
            "pruned": self.n_pruned,
            "trials": len(self.trials),
        }


class Tuner:
    """Strategy-driven autotuner with incumbent pruning.

    ``strategy`` is any :class:`~repro_torch.core.strategy.SearchStrategy`;
    the default is the paper's exhaustive visit. ``order``/``seed`` are
    kept as a deprecated alias for
    ``strategy=ExhaustiveStrategy(order, seed)`` — passing both ``order``
    and ``strategy`` is an error.
    """

    def __init__(self, space: SearchSpace, settings: EvaluationSettings,
                 strategy: Optional[SearchStrategy] = None,
                 order: Optional[str] = None, seed: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if strategy is not None and order is not None:
            raise ValueError("pass either strategy= or the deprecated "
                             "order= alias, not both")
        if strategy is None:
            strategy = ExhaustiveStrategy(order=order or "exhaustive",
                                          seed=seed)
        self.space = space
        self.settings = settings
        self.strategy = strategy
        self.order = getattr(strategy, "order", strategy.order_label)
        self.seed = seed
        self.clock = clock

    def tune(self, benchmark: BenchmarkFactory,
             progress: Optional[Callable[[Config, EvalResult], None]] = None,
             backend: Optional[ExecutionBackend] = None,
             cache=None, warm_start: bool = False,
             seeds: Sequence[Config] = (),
             ledger=None, timestamp: Optional[float] = None,
             validate: str = "warn",
             pipeline: "str | CompilePipeline | None" = "auto",
             ) -> TuningResult:
        """Search the space for the best configuration.

        ``backend`` schedules the evaluations (default
        :class:`~repro_torch.core.executor.SerialBackend`, the paper's loop);
        ``cache`` is a :class:`~repro_torch.core.cache.BoundCache` — configs
        already in it are served without re-evaluation and fresh results
        are appended; ``warm_start`` additionally seeds the incumbent from
        the best cached trial so pruning bites from trial 1. ``seeds`` are
        transfer-tuning warm-start configurations (e.g. a related
        benchmark's cached incumbents from ``TrialCache.suggest_seeds``);
        they are projected into the space and handed to the strategy,
        which evaluates them first. ``ledger`` is a
        :class:`~repro_torch.history.ledger.BoundLedger`: on completion the
        run's incumbent (config, pooled moments, strategy, settings key)
        is appended to the performance-history ledger, stamped with the
        caller-supplied ``timestamp`` — the engine itself never reads a
        clock for record content.

        ``validate`` gates the pre-run **workload audit**
        (:mod:`repro_torch.lint`): when the benchmark exposes an
        ``audit_spec`` attribute, its declared work term is cross-checked
        against the traced kernel cost for the space's first
        configuration *before any trial executes*. ``"warn"`` (default)
        raises :class:`~repro_torch.lint.WorkloadAuditWarning`s and
        proceeds; ``"strict"`` raises
        :class:`~repro_torch.lint.WorkloadAuditError` instead, so a
        mis-declared workload never burns measurement time; ``"off"``
        skips the audit.

        ``pipeline`` controls **pipelined compilation**: when the
        benchmark exposes a ``precompile(config)`` hook (the standard
        factories warm the :class:`~repro_torch.core.exec_cache.ExecutableCache`
        from ``TensorSpec``s — building a hand kernel's library on the
        first miss), every fresh config in a proposed
        batch is submitted to a background
        :class:`~repro_torch.core.exec_cache.CompilePipeline` before the batch
        executes — trial k+1's executable compiles while trial k runs.
        ``"auto"`` (default) enables this on the serial and thread
        backends; ``None``/``"off"`` disables it; an explicit
        :class:`CompilePipeline` is used as-is (and left open for the
        caller to close). The cache's in-flight deduplication guarantees
        a trial never compiles what the pipeline already started.
        """
        from .cache import settings_key

        reg = obs_metrics()
        if validate not in ("off", "warn", "strict"):
            raise ValueError(f"validate must be 'off', 'warn' or 'strict', "
                             f"got {validate!r}")
        if validate != "off":
            self._validate_workload(benchmark, strict=validate == "strict")
        if backend is None:
            backend = SerialBackend(clock=self.clock)
        strategy = self.strategy
        direction = self.settings.direction
        session_key = settings_key(self.settings)
        cell = IncumbentCell(direction)
        if cache is not None and warm_start:
            # settings parity: never seed the incumbent from a trial
            # measured under other settings (e.g. a halving rung budget)
            best = cache.best(direction, settings_key=session_key)
            if best is not None:
                cell.offer(best[0], best[1])
        projected = self._project_seeds(seeds)
        strategy.reset(self.space, self.settings, seeds=projected)
        evaluate = EvaluateTask(self.settings, benchmark, clock=self.clock)
        hint = getattr(backend, "batch_hint", None)
        precompile = getattr(benchmark, "precompile", None)
        own_pipeline = False
        if pipeline == "auto":
            # pipelining pays off only where compiles land in this
            # process: the serial and thread backends
            if precompile is not None and \
                    getattr(backend, "name", "") in ("serial", "thread"):
                pipeline = CompilePipeline()
                own_pipeline = True
            else:
                pipeline = None
        elif pipeline == "off":
            pipeline = None
        if pipeline is not None and precompile is None:
            pipeline = None
        records: list[TrialRecord] = []
        # effective settings key of the batch currently executing; observe
        # runs between generator resumes, so this is stable per batch
        current_key = {"value": session_key}

        def batches():
            while True:
                asked = strategy.ask(hint)
                if asked is None or not asked.configs:
                    return
                fresh: list[Config] = []
                for cfg in asked.configs:
                    # cache hits are only served for batches without a
                    # settings override AND records measured under the
                    # tuner's own settings — a rung-truncated trial must
                    # never pass for a full-budget one
                    hit = cache.get(cfg, settings_key=session_key) \
                        if cache is not None and asked.settings is None \
                        else None
                    if hit is not None:
                        if not hit.pruned:
                            cell.offer(cfg, hit.score)
                        strategy.tell(cfg, hit)
                        trace_instant("cache_hit", config=dict(cfg),
                                      score=hit.score, pruned=hit.pruned,
                                      stop_reason=hit.stop_reason,
                                      samples=hit.total_samples)
                        reg.inc("trials.cached")
                        records.append(TrialRecord(config=cfg, result=hit,
                                                   cached=True))
                        if progress is not None:
                            progress(cfg, hit)
                    else:
                        fresh.append(cfg)
                if fresh:
                    if pipeline is not None:
                        # submitted before the batch executes: the worker
                        # compiles ahead while the backend measures, and
                        # a trial that overtakes it just waits on the
                        # cache's in-flight entry instead of recompiling
                        for cfg in fresh:
                            pipeline.submit(
                                lambda c=cfg: precompile(c))
                    current_key["value"] = session_key \
                        if asked.settings is None \
                        else settings_key(asked.settings)
                    yield Batch(tuple(fresh), asked.settings)

        def persist(outcome: TrialOutcome) -> None:
            # called by the backend as soon as the trial finishes — from
            # the worker thread on concurrent backends (TrialCache.put is
            # thread-safe) — so a killed run keeps every completed trial
            reg.inc("trials.completed")
            if outcome.result.pruned:
                reg.inc("trials.pruned")
            if cache is not None:
                with phase("cache_io"):
                    cache.put(outcome.config, outcome.result,
                              strategy=strategy.name,
                              settings_key=current_key["value"])

        def observe(outcome: TrialOutcome) -> None:
            strategy.tell(outcome.config, outcome.result)
            records.append(TrialRecord(config=outcome.config,
                                       result=outcome.result,
                                       worker=outcome.worker))

        t0 = self.clock()
        # per-session observability deltas: snapshot the process-global
        # registries at entry, report only the movement at exit
        metrics_at_entry = reg.snapshot()
        exec_at_entry = default_cache().stats
        recorder = trace_sink()
        try:
            with trace_span(
                    "tune", cat="session", context=True,
                    strategy=strategy.name,
                    backend=getattr(backend, "name", "?"),
                    n_workers=getattr(backend, "n_workers", 1),
                    settings=self.settings.label(),
                    settings_key=session_key) as session_span:
                _, stats = backend.run(batches(), evaluate, cell,
                                       progress=progress, observe=observe,
                                       persist=persist)
                session_span.set(n_trials=len(records))
        finally:
            n_precompiled = 0
            if pipeline is not None:
                if own_pipeline:
                    # discard queued leftovers; the in-flight task (if
                    # any) finishes — never kill a compile mid-way
                    pipeline.close(wait=False)
                n_precompiled = pipeline.counts[1]
        exec_delta = default_cache().stats.delta(exec_at_entry)
        for key, moved in (("exec_cache.hits", exec_delta.hits),
                           ("exec_cache.misses", exec_delta.misses),
                           ("exec_cache.compiles", exec_delta.compiles)):
            if moved:
                reg.inc(key, moved)
        metrics_delta = reg.delta(metrics_at_entry)
        if recorder is not None:
            recorder.meta_event(metrics=metrics_delta,
                                exec_cache=exec_delta.to_json())
        best_cfg, best_score = cell.snapshot()
        trials = tuple(records)
        result = TuningResult(
            best_config=best_cfg,
            best_score=best_score,
            trials=trials,
            total_time_s=self.clock() - t0,
            total_samples=sum(t.result.total_samples for t in trials),
            n_pruned=sum(1 for t in trials if t.result.pruned),
            settings_label=self.settings.label(),
            order=strategy.order_label,
            backend=stats.backend,
            n_workers=stats.n_workers,
            serial_time_s=stats.serial_time_s,
            parallel_time_s=stats.parallel_time_s,
            n_cached=sum(1 for t in trials if t.cached),
            improvements=cell.history(),
            strategy=strategy.name,
            batches=stats.batches,
            n_seeded=len(projected),
            n_precompiled=n_precompiled,
            trace_path=str(recorder.path)
            if recorder is not None and getattr(recorder, "path", None)
            else None,
            metrics=metrics_delta,
            exec_cache=exec_delta.to_json(),
        )
        if ledger is not None:
            # duck-typed BoundLedger so core never imports the history layer
            ledger.record(result, settings_key=session_key,
                          timestamp=timestamp, direction=direction)
        return result

    def _validate_workload(self, benchmark, strict: bool) -> None:
        """Pre-run measurement-soundness audit (lint pass 1).

        Audits the benchmark's ``audit_spec`` against the space's first
        configuration. Info-level findings (MS100: benchmark opted out)
        are always silent; anything else raises
        :class:`~repro_torch.lint.WorkloadAuditError` in strict mode or is
        surfaced as :class:`~repro_torch.lint.WorkloadAuditWarning`s
        otherwise. Audit *machinery* failures never abort a warn-mode
        run."""
        import warnings

        from ..lint import (WorkloadAuditError, WorkloadAuditWarning,
                            audit_benchmark)
        try:
            config = next(iter(self.space.configs()))
        except StopIteration:
            return   # empty space: tune() will produce an empty result
        try:
            findings = [f for f in audit_benchmark(benchmark, config)
                        if f.severity != "info"]
        except Exception as e:
            if strict:
                raise
            warnings.warn(f"workload audit could not run: "
                          f"{type(e).__name__}: {e}",
                          WorkloadAuditWarning, stacklevel=3)
            return
        if not findings:
            return
        if strict:
            raise WorkloadAuditError(findings)
        for f in findings:
            warnings.warn(f.render(), WorkloadAuditWarning, stacklevel=3)

    def _project_seeds(self, seeds: Sequence[Config]) -> tuple[Config, ...]:
        """Map transfer seeds into this space (nearest in-space config),
        dropping duplicates and constraint-violating projections."""
        from .cache import config_key
        out: list[Config] = []
        seen: set[str] = set()
        for cfg in seeds:
            proj = self.space.project(cfg)
            if proj is None:
                continue
            key = config_key(proj)
            if key not in seen:
                seen.add(key)
                out.append(proj)
        return tuple(out)


def compare_techniques(space: SearchSpace, benchmark: BenchmarkFactory,
                       base: EvaluationSettings,
                       techniques: Optional[dict[str, tuple[
                           EvaluationSettings,
                           "str | SearchStrategy"]]] = None,
                       backend: Optional[ExecutionBackend] = None,
                       cache=None, warm_start: bool = False,
                       cache_prefix: str = "technique",
                       ) -> dict[str, TuningResult]:
    """Run the paper's technique grid (Default / C / C+I / C+I+O, +-R) on one
    benchmark and return the per-technique :class:`TuningResult`s.

    This is the engine behind the Tables VIII-XI reproduction. ``backend``
    schedules every technique's evaluations (so the grid can run on the
    thread pool); ``cache`` is an *unbound*
    :class:`~repro_torch.core.cache.TrialCache` — each technique gets its own
    benchmark namespace (``<cache_prefix>:<label>``) so the grid is
    resumable without cross-technique contamination, and ``warm_start``
    seeds each technique's incumbent from its own cached best.

    A technique row is ``(settings, order)`` where ``order`` is either a
    visit-order string for the exhaustive strategy (the paper's rows) or
    a :class:`~repro_torch.core.strategy.SearchStrategy` instance — so the grid
    can pit the paper's techniques against another strategy under
    identical evaluation settings.
    """
    if techniques is None:
        techniques = standard_techniques(base)
    out: dict[str, TuningResult] = {}
    for label, (settings, order) in techniques.items():
        bound = cache.bound(f"{cache_prefix}:{label}") \
            if cache is not None else None
        tuner = Tuner(space, settings, order=order) if isinstance(order, str) \
            else Tuner(space, settings, strategy=order)
        out[label] = tuner.tune(
            benchmark, backend=backend, cache=bound, warm_start=warm_start)
    return out


def tune_successive_halving(space: SearchSpace, benchmark: BenchmarkFactory,
                            base: EvaluationSettings, eta: int = 3,
                            min_iterations: int = 4,
                            clock: Callable[[], float] = time.perf_counter,
                            ) -> TuningResult:
    """Successive halving with CI-informed promotion (beyond-paper,
    DESIGN.md §8.3).

    Compatibility wrapper: the loop now lives in
    :class:`~repro_torch.core.strategy.SuccessiveHalvingStrategy`, which runs
    through the same engine as every other strategy — prefer
    ``Tuner(space, base, strategy=SuccessiveHalvingStrategy(...))``, which
    adds backend/cache/warm-start support this wrapper predates.
    """
    strategy = SuccessiveHalvingStrategy(eta=eta,
                                         min_iterations=min_iterations)
    result = Tuner(space, base, strategy=strategy, clock=clock).tune(benchmark)
    return dataclasses.replace(result, settings_label="SuccessiveHalving",
                               order="exhaustive")


def standard_techniques(base: EvaluationSettings,
                        ) -> dict[str, tuple[EvaluationSettings, str]]:
    """The paper's Tables VIII-XI rows (minus hand-tuned rows, which are
    constructed by the benchmark harness since they need manual counts)."""

    def with_flags(**kw) -> EvaluationSettings:
        return dataclasses.replace(base, **kw)

    c = dict(use_ci_convergence=True)
    ci = dict(use_ci_convergence=True, use_inner_prune=True)
    cio = dict(use_ci_convergence=True, use_inner_prune=True,
               use_outer_prune=True)
    return {
        "Default": (with_flags(), "exhaustive"),
        "Single": (with_flags(max_invocations=1, max_iterations=1), "exhaustive"),
        "Confidence": (with_flags(**c), "exhaustive"),
        "C+Inner": (with_flags(**ci), "exhaustive"),
        "C+Inner+R": (with_flags(**ci), "reverse"),
        "C+I+Outer": (with_flags(**cio), "exhaustive"),
        "C+I+O+R": (with_flags(**cio), "reverse"),
    }
