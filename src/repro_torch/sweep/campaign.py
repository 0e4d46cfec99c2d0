"""Sweep campaigns: tune a benchmark family across a grid of shapes.

The paper tunes each benchmark shape in isolation; "From Roofline to
Ruggedness" shows adjacent GEMM shapes can differ enough that per-shape
tuning is mandatory, and exhaustive per-shape search cannot scale. A
:class:`SweepCampaign` walks a *shape grid* (itself a
:class:`~repro_torch.core.searchspace.SearchSpace` — same declarative layer as
config spaces) and tunes each shape through a full
:class:`~repro_torch.core.cache.TuningSession`, so the existing machinery does
all the heavy lifting:

  * every shape gets its own benchmark namespace
    (``"<base>@<shape_key>"``, :mod:`repro_torch.sweep.shapes`) in **one shared
    cache file** — resumable per shape, reportable as one campaign;
  * every completed shape appends a ledger record (strategy ``"sweep"``,
    ``campaign=<name>``), so history dashboards grow one trend series per
    shape;
  * each shape's :class:`~repro_torch.sweep.strategy.SweepStrategy` is warmed
    with **per-fingerprint priors**: all cached trials of sibling shapes
    under this machine's hardware fingerprint, encoded with their own
    shape features. The first shape explores; later shapes start from the
    joint model and spend their budget refining.

After (or during) a campaign, :meth:`SweepCampaign.oracle` builds the
dispatch-time :class:`~repro_torch.sweep.oracle.ConfigOracle` over the
campaign's cache.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from pathlib import Path
from typing import Callable, Optional, Sequence

from ..core.cache import AUTO_LEDGER, TrialCache, TuningSession
from ..core.evaluator import EvaluationSettings
from ..core.profiling import trace_span
from ..core.searchspace import Config, SearchSpace
from ..core.tuner import TrialRecord, Tuner, TuningResult

from .oracle import ConfigOracle
from .shapes import SHAPE_SEP, shape_benchmark_name, shape_key, \
    split_benchmark_name
from .strategy import Prior, SweepStrategy

__all__ = ["CampaignResult", "ShapeOutcome", "SweepCampaign"]

#: a benchmark family: shape → benchmark factory (config → invocation factory)
BenchmarkFamily = Callable[[Config], Callable]


@dataclasses.dataclass(frozen=True)
class ShapeOutcome:
    """One swept shape's tuning outcome."""

    shape: Config
    benchmark: str          # cache/ledger namespace ("<base>@<shape_key>")
    result: object          # the session's TuningResult

    @property
    def n_trials(self) -> int:
        return len(self.result.trials)


@dataclasses.dataclass(frozen=True)
class CampaignResult:
    """Outcome of one :meth:`SweepCampaign.run`."""

    name: str
    base: str
    outcomes: tuple[ShapeOutcome, ...]
    trace_path: Optional[str] = None   # campaign trace JSONL, when traced

    @property
    def total_trials(self) -> int:
        """Trials across all swept shapes (including cache-served ones)."""
        return sum(o.n_trials for o in self.outcomes)

    def outcome_for(self, shape: Config) -> Optional[ShapeOutcome]:
        want = shape_key(shape)
        for o in self.outcomes:
            if shape_key(o.shape) == want:
                return o
        return None


class SweepCampaign:
    """Tunes ``family`` over every shape of ``shape_space``.

    ``family`` maps a shape to a benchmark factory (the shape-specialized
    objective); ``config_space`` is shared by all shapes. ``name`` is the
    session/cache name (one ``<cache_dir>/<name>.jsonl`` holds the whole
    campaign) and the ledger's campaign stamp; ``base`` (default: the
    campaign name) prefixes per-shape benchmark names.
    ``budget_per_shape`` caps each shape's proposals — the whole point of
    the sweep layer is that this can sit far below the config space's
    cardinality once priors kick in. Campaigns are resumable exactly like
    sessions: a killed ``run()`` re-serves finished shapes from cache.

    ``validate`` gates each shape's pre-run workload audit (see
    ``Tuner.tune``): ``"warn"`` (default), ``"strict"`` or ``"off"``.
    """

    def __init__(self, config_space: SearchSpace, shape_space: SearchSpace,
                 family: BenchmarkFamily, settings: EvaluationSettings,
                 name: str = "sweep", base: Optional[str] = None,
                 cache_dir: str | os.PathLike = ".tuning_sessions",
                 budget_per_shape: Optional[int] = None,
                 model: str = "ridge", acquisition: str = "ei",
                 seed: Optional[int] = 0,
                 fingerprint: Optional[str] = None,
                 ledger=AUTO_LEDGER, validate: str = "warn"):
        if base is not None and SHAPE_SEP in base:
            raise ValueError(f"base name {base!r} contains {SHAPE_SEP!r}")
        self.config_space = config_space
        self.shape_space = shape_space
        self.family = family
        self.settings = settings
        self.name = name
        self.base = base or name
        self.cache_dir = Path(cache_dir)
        self.budget_per_shape = budget_per_shape
        self.model = model
        self.acquisition = acquisition
        self.seed = seed
        self.fingerprint = fingerprint
        self.ledger = ledger
        self.validate = validate

    @property
    def cache_path(self) -> Path:
        return self.cache_dir / f"{self.name}.jsonl"

    def _cache(self) -> TrialCache:
        return TrialCache(self.cache_path, fingerprint=self.fingerprint)

    def priors(self, exclude: Optional[Config] = None) -> list[Prior]:
        """(shape, config, score) triples from every cached sibling trial
        under this machine's fingerprint — what warms each shape's
        surrogate. Pruned trials are included (truncated means are noisier
        but unbiased; see ``SurrogateStrategy.tell``); ``exclude`` drops
        one shape's own trials (its session serves those from cache
        directly)."""
        cache = self._cache()
        skip = shape_key(exclude) if exclude is not None else None
        out: list[Prior] = []
        for bench in cache.benchmarks(prefix=self.base + SHAPE_SEP):
            _, shape = split_benchmark_name(bench)
            if shape is None or shape_key(shape) == skip:
                continue
            for _, cfg, res in cache.items(bench):
                out.append((shape, cfg, float(res.score)))
        return out

    def session_for(self, shape: Config, priors: Sequence[Prior] = (),
                    seed_offset: int = 0) -> TuningSession:
        """The :class:`TuningSession` that tunes one shape — exposed so a
        caller can drive shapes manually (distributed campaigns)."""
        strategy = SweepStrategy(
            shape, self.shape_space, priors=priors,
            budget=self.budget_per_shape, model=self.model,
            acquisition=self.acquisition,
            seed=None if self.seed is None else self.seed + seed_offset)
        tuner = Tuner(self.config_space, self.settings, strategy=strategy)
        return TuningSession(
            self.name, tuner, self.family(shape),
            cache_dir=self.cache_dir,
            benchmark_name=shape_benchmark_name(self.base, shape),
            fingerprint=self.fingerprint, ledger=self.ledger,
            campaign=self.name)

    def _finished_result(self, benchmark: str,
                         cache: TrialCache) -> Optional[TuningResult]:
        """A budget-complete shape's outcome, served straight from cache.
        Proposals are prior-dependent, so a resumed campaign re-running a
        finished shape would propose under a *richer* prior set than the
        original run and spend fresh trials on a diverged sequence —
        instead, a shape whose cached trial count already meets
        ``budget_per_shape`` is replayed without touching the tuner (and
        without appending a duplicate ledger record)."""
        if self.budget_per_shape is None:
            return None
        rows = cache.items(benchmark)
        if len(rows) < self.budget_per_shape:
            return None
        if any(cfg not in self.config_space for _, cfg, _ in rows):
            # the namespace holds another config space's trials (e.g. a
            # cache reused across benchmark families) — tune normally and
            # let the session layer serve only matching config keys
            return None
        direction = self.settings.direction
        trials = tuple(TrialRecord(config=cfg, result=res, cached=True)
                       for _, cfg, res in rows)
        best = None
        for t in trials:
            if t.result.pruned:
                continue
            if best is None or direction.better(t.result.score,
                                                best.result.score):
                best = t
        return TuningResult(
            best_config=None if best is None else dict(best.config),
            best_score=None if best is None else float(best.result.score),
            trials=trials,
            total_time_s=0.0,
            total_samples=sum(t.result.total_samples for t in trials),
            n_pruned=sum(1 for t in trials if t.result.pruned),
            settings_label=self.settings.label(),
            order=SweepStrategy.name,
            n_cached=len(trials),
            strategy=SweepStrategy.name,
        )

    def run(self, shapes: Optional[Sequence[Config]] = None,
            holdout: Sequence[Config] = (), backend=None,
            timestamp: Optional[float] = None,
            progress=None,
            trace: "bool | str | os.PathLike" = False) -> CampaignResult:
        """Tune every shape (grid order), skipping ``holdout`` shapes —
        the oracle-evaluation protocol tunes the grid minus one shape and
        asks the oracle about the one it never saw. ``backend``,
        ``timestamp`` and ``progress`` are forwarded to each session's
        ``run``; priors are re-collected from the shared cache before
        each shape, so shape *i* benefits from shapes 0..i-1 (and from
        any earlier campaign run into the same cache).

        ``trace`` records the whole campaign into one span trace
        (``True`` → ``<cache_dir>/<name>.trace.jsonl``, or pass a path):
        a ``campaign`` root span with one ``shape`` span per tuned shape,
        each enclosing that shape's session/trial spans. If a recorder is
        already installed (an enclosing harness), it is reused and the
        flag only adds the campaign/shape spans."""
        held = {shape_key(s) for s in holdout}
        todo = [s for s in (shapes if shapes is not None
                            else self.shape_space.ordered("exhaustive"))
                if shape_key(s) not in held]
        outcomes: list[ShapeOutcome] = []
        trace_path: Optional[str] = None
        with contextlib.ExitStack() as stack:
            from ..obs.trace import TraceRecorder, recorder
            if trace and recorder() is None:
                path = (self.cache_dir / f"{self.name}.trace.jsonl"
                        if trace is True else Path(trace))
                stack.enter_context(
                    TraceRecorder(path, session=self.name,
                                  meta={"campaign": self.name,
                                        "base": self.base}))
            active = recorder()
            if active is not None and getattr(active, "path", None):
                trace_path = str(active.path)
            with trace_span("campaign", cat="session", context=True,
                            campaign=self.name, base=self.base,
                            n_shapes=len(todo)) as cspan:
                for j, shape in enumerate(todo):
                    bench = shape_benchmark_name(self.base, shape)
                    result = self._finished_result(bench, self._cache())
                    with trace_span("shape", cat="shape", context=True,
                                    shape=dict(shape),
                                    benchmark=bench) as sspan:
                        if result is None:
                            session = self.session_for(
                                shape, priors=self.priors(exclude=shape),
                                seed_offset=j)
                            result = session.run(backend=backend,
                                                 timestamp=timestamp,
                                                 progress=progress,
                                                 validate=self.validate)
                        else:
                            sspan.set(served_from_cache=True)
                        sspan.set(n_trials=len(result.trials),
                                  best_score=result.best_score)
                    outcomes.append(ShapeOutcome(shape=dict(shape),
                                                 benchmark=bench,
                                                 result=result))
                cspan.set(total_trials=sum(len(o.result.trials)
                                           for o in outcomes))
        return CampaignResult(name=self.name, base=self.base,
                              outcomes=tuple(outcomes),
                              trace_path=trace_path)

    def oracle(self, model: Optional[str] = None,
               min_shapes: int = 2) -> ConfigOracle:
        """The dispatch-time config oracle over this campaign's cache."""
        return ConfigOracle(self.config_space, self.shape_space,
                            self._cache(), base=self.base,
                            direction=self.settings.direction,
                            model=model or self.model,
                            min_shapes=min_shapes)
