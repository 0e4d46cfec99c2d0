"""Persistent trial cache + resumable tuning sessions.

Real kernel-tuner infrastructure never throws trial data away: a search
interrupted at config 40/96 should restart at 41, and a nightly re-tune on
identical hardware should reuse yesterday's measurements outright (cf.
*Towards a Benchmarking Suite for Kernel Tuners*, arXiv:2303.08976). This
module provides:

  * :func:`hardware_fingerprint` — identifies the measurement substrate
    (card name, compute capability and count, torch and CUDA versions;
    or the host CPU for ``device="cpu"``). Trials recorded under a
    different fingerprint are ignored on load: timings do not transfer
    across hardware.
  * :class:`TrialCache` — an append-only JSONL store keyed by
    (benchmark name, canonical config). Each record round-trips the full
    :class:`~repro_torch.core.evaluator.EvalResult`, including every
    invocation's Welford moments (count/mean/m2) *exactly* — JSON float
    serialization uses ``repr`` so float64 survives bit-for-bit — which
    keeps downstream parallel Welford merges exact across a resume.
  * :class:`BoundCache` — a :class:`TrialCache` view fixed to one
    benchmark name, the shape ``Tuner.tune(cache=...)`` consumes.
  * :class:`TuningSession` — a named run/resume wrapper: restarting a
    killed session skips every already-evaluated config and warm-starts
    the incumbent from the best cached trial so stop-condition-4 pruning
    bites from trial 1.
  * a read/query layer for reporting: :class:`CachedTrial`,
    :func:`iter_trials` and :func:`load_trials` read cache files across
    *all* hardware fingerprints (unlike :class:`TrialCache`, which serves
    only its own fingerprint), so downstream consumers — notably
    :mod:`repro_torch.core.report` — can group sessions by benchmark ×
    fingerprint and assemble roofline dashboards without re-measuring.

The on-disk format is the JAX package's, byte for byte (specified in
``docs/cache-format.md``; ``CACHE_VERSION`` gates compatibility), so
either package reads trials the other wrote.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from pathlib import Path
from typing import Iterable, Iterator, Optional

from ..obs.metrics import metrics as obs_metrics
from .confidence import spearman
from .evaluator import EvalResult, InvocationResult
from .searchspace import Config
from .stop_conditions import Direction

__all__ = ["AUTO_LEDGER", "BoundCache", "CACHE_VERSION", "CachedTrial",
           "TrialCache", "TuningSession", "config_key",
           "hardware_fingerprint", "iter_trials", "load_trials",
           "settings_key"]

CACHE_VERSION = 1

_FINGERPRINTS: dict[str, str] = {}
_FINGERPRINT_LOCK = threading.Lock()


def hardware_fingerprint(device: str = "cuda") -> str:
    """Stable id of the measurement substrate ``device`` names, cached per
    process.

    ``"cuda"`` (the default) fingerprints the card the session measures:
    ``cuda:<name>:sm<major><minor>:n<count>:torch-<ver>+cu<ver>``. It
    raises when no card is visible — trials timed on the host must never
    be filed under a device fingerprint. ``"cpu"`` fingerprints the host:
    ``cpu:<machine>:torch-<ver>``. Nothing here runs at import time, so
    importing this module never initialises CUDA.
    """
    import torch

    kind = torch.device(device).type
    with _FINGERPRINT_LOCK:
        fp = _FINGERPRINTS.get(kind)
        if fp is not None:
            return fp
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("hardware_fingerprint('cuda'): no CUDA "
                                   "device is available")
            major, minor = torch.cuda.get_device_capability(0)
            fp = (f"cuda:{torch.cuda.get_device_name(0)}:sm{major}{minor}"
                  f":n{torch.cuda.device_count()}"
                  f":torch-{torch.__version__}+cu{torch.version.cuda}")
        elif kind == "cpu":
            import platform
            fp = f"cpu:{platform.machine()}:torch-{torch.__version__}"
        else:
            raise ValueError(f"no fingerprint for device {device!r}")
        _FINGERPRINTS[kind] = fp
        return fp


def config_key(config: Config) -> str:
    """Canonical JSON key of a configuration (order-insensitive)."""
    return json.dumps(config, sort_keys=True, separators=(",", ":"),
                      default=str)


def settings_key(settings) -> str:
    """Short stable fingerprint of an :class:`EvaluationSettings`.

    A trial is only as good as the budget it was measured under: a
    successive-halving rung evaluated at ``max_iterations=4`` must never
    be served back as a full-budget result. Records carry this key so
    cache reads can demand settings parity; records written before the
    key existed (or by hand) have none and match any request.
    """
    d = dataclasses.asdict(settings)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12]


def _result_to_json(result: EvalResult) -> dict:
    return {
        "score": result.score,
        "best_invocation": result.best_invocation,
        "total_samples": result.total_samples,
        "total_time_s": result.total_time_s,
        "measured_time_s": result.measured_time_s,
        "pruned": result.pruned,
        "stop_reason": result.stop_reason,
        "invocations": [
            {"mean": i.mean, "count": i.count, "elapsed_s": i.elapsed_s,
             "stop_reason": i.stop_reason, "pruned": i.pruned, "m2": i.m2}
            for i in result.invocations],
    }


def _result_from_json(d: dict) -> EvalResult:
    return EvalResult(
        score=d["score"],
        best_invocation=d["best_invocation"],
        invocations=tuple(InvocationResult(**inv)
                          for inv in d["invocations"]),
        total_samples=d["total_samples"],
        total_time_s=d["total_time_s"],
        measured_time_s=d["measured_time_s"],
        pruned=d["pruned"],
        stop_reason=d["stop_reason"])


@dataclasses.dataclass(frozen=True)
class CachedTrial:
    """One persisted trial, as the reporting layer sees it: unlike the
    entries :class:`TrialCache` serves back to the tuner, a CachedTrial
    carries its hardware fingerprint so trials from many machines can
    coexist in one analysis, plus the name of the search strategy that
    produced it (``None`` for records predating the strategy layer)."""

    benchmark: str
    fingerprint: str
    config: Config
    result: EvalResult
    strategy: Optional[str] = None

    @property
    def key(self) -> str:
        return config_key(self.config)


def iter_trials(path: str | os.PathLike) -> Iterator[CachedTrial]:
    """Yield every readable trial in a cache file, across *all* hardware
    fingerprints (``TrialCache`` filters to one; reports want them all).

    Tolerates a torn trailing line and skips records whose
    ``CACHE_VERSION`` does not match. Records are yielded in file order,
    so re-evaluated configs appear more than once — last one wins; use
    :func:`load_trials` for the deduplicated view.
    """
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue   # torn trailing write from a killed run
            if rec.get("version") != CACHE_VERSION:
                continue
            yield CachedTrial(benchmark=rec["benchmark"],
                              fingerprint=rec["fingerprint"],
                              config=rec["config"],
                              result=_result_from_json(rec["result"]),
                              strategy=rec.get("strategy"))


def load_trials(path: str | os.PathLike) -> list[CachedTrial]:
    """Load the deduplicated trials of a cache file *or* of every
    ``*.jsonl`` under a directory of session caches.

    Duplicate (benchmark, fingerprint, config) records keep the last
    occurrence — the same resolution :class:`TrialCache` applies on load —
    while preserving first-seen order, so incumbent extraction downstream
    breaks score ties exactly like ``TrialCache.best``.
    """
    p = Path(path)
    files: Iterable[Path] = sorted(p.glob("*.jsonl")) if p.is_dir() else (p,)
    dedup: dict[tuple[str, str, str], CachedTrial] = {}
    for f in files:
        for t in iter_trials(f):
            dedup[(t.benchmark, t.fingerprint, t.key)] = t
    return list(dedup.values())


class TrialCache:
    """Append-only JSONL store of evaluated trials.

    Thread-safe: concurrent backends write through one lock, and every
    record is flushed as a single line so a killed process loses at most
    the trial in flight (a torn trailing line is tolerated on load).
    """

    def __init__(self, path: str | os.PathLike,
                 fingerprint: Optional[str] = None):
        self.path = Path(path)
        self.fingerprint = fingerprint or hardware_fingerprint()
        self._lock = threading.Lock()
        # settings-keyed store: records measured under different
        # EvaluationSettings coexist — a halving rung's truncated trial
        # never shadows (or is shadowed by) a full-budget record of the
        # same config.
        # (benchmark, config_key, settings_key-or-None) ->
        #     (config, EvalResult, strategy-or-None)
        self._entries: dict[
            tuple[str, str, Optional[str]],
            tuple[Config, EvalResult, Optional[str]]] = {}
        # wildcard view: last write per (benchmark, config_key), first-seen
        # position preserved — the pre-settings-key lookup semantics
        self._latest: dict[
            tuple[str, str],
            tuple[Config, EvalResult, Optional[str], Optional[str]]] = {}
        self.n_stale = 0   # records skipped on load (other hardware/version)
        if self.path.exists():
            self._load()

    def _load(self) -> None:
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue   # torn trailing write from a killed run
                if (rec.get("version") != CACHE_VERSION
                        or rec.get("fingerprint") != self.fingerprint):
                    self.n_stale += 1
                    continue
                bench, ckey = rec["benchmark"], config_key(rec["config"])
                skey = rec.get("settings_key")
                entry = (rec["config"], _result_from_json(rec["result"]),
                         rec.get("strategy"))
                self._entries[(bench, ckey, skey)] = entry
                self._latest[(bench, ckey)] = entry + (skey,)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- query layer (reporting) ----------------------------------------------
    def benchmarks(self, prefix: Optional[str] = None) -> list[str]:
        """Benchmark names with at least one cached trial, sorted. With
        ``prefix``, only names starting with it — how the sweep layer
        finds every per-shape benchmark of one campaign
        (``"<base>@" + shape_key``)."""
        with self._lock:
            return sorted({bench for bench, _ in self._latest
                           if prefix is None or bench.startswith(prefix)})

    def items(self, benchmark: Optional[str] = None,
              ) -> list[tuple[str, Config, EvalResult]]:
        """Snapshot of cached trials as (benchmark, config, result) tuples
        — the latest record per config, in first-seen order, optionally
        restricted to one benchmark."""
        with self._lock:
            return [(bench, cfg, res)
                    for (bench, _), (cfg, res, *_meta)
                    in self._latest.items()
                    if benchmark is None or bench == benchmark]

    def trials(self) -> list[CachedTrial]:
        """This cache's entries as :class:`CachedTrial`s — latest record
        per config, all stamped with the cache's own fingerprint
        (stale-fingerprint records were dropped on load; use
        :func:`load_trials` to see every machine)."""
        with self._lock:
            return [CachedTrial(benchmark=bench, fingerprint=self.fingerprint,
                                config=cfg, result=res, strategy=strat)
                    for (bench, _), (cfg, res, strat, _skey)
                    in self._latest.items()]

    def get(self, benchmark: str, config: Config,
            settings_key: Optional[str] = None) -> Optional[EvalResult]:
        """Cached result for a config. With ``settings_key``, only a
        record measured under those settings (or a legacy record with no
        key) satisfies the read — a halving rung's truncated trial never
        passes for a full-budget one. Without it, the latest record per
        config wins (the pre-settings-key semantics)."""
        ckey = config_key(config)
        with self._lock:
            if settings_key is not None:
                hit = self._entries.get((benchmark, ckey, settings_key)) \
                    or self._entries.get((benchmark, ckey, None))
                return hit[1] if hit is not None else None
            hit = self._latest.get((benchmark, ckey))
            return hit[1] if hit is not None else None

    def put(self, benchmark: str, config: Config, result: EvalResult,
            strategy: Optional[str] = None,
            settings_key: Optional[str] = None) -> None:
        rec = {"version": CACHE_VERSION, "fingerprint": self.fingerprint,
               "benchmark": benchmark, "config": config,
               "result": _result_to_json(result)}
        if strategy is not None:
            rec["strategy"] = strategy
        if settings_key is not None:
            rec["settings_key"] = settings_key
        line = json.dumps(rec, default=str)
        ckey = config_key(config)
        entry = (config, result, strategy)
        # the threading lock serializes writers in this process; the
        # advisory flock serializes them across processes — parallel
        # sessions (or a session racing a report) share one cache file,
        # and interleaved buffered appends would tear both records
        try:
            import fcntl
        except ImportError:              # pragma: no cover - non-POSIX
            fcntl = None
        with self._lock:
            self._entries[(benchmark, ckey, settings_key)] = entry
            self._latest[(benchmark, ckey)] = entry + (settings_key,)
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as f:
                if fcntl is not None:
                    fcntl.flock(f.fileno(), fcntl.LOCK_EX)
                try:
                    f.write(line + "\n")
                    f.flush()
                finally:
                    if fcntl is not None:
                        fcntl.flock(f.fileno(), fcntl.LOCK_UN)
        reg = obs_metrics()
        reg.inc("cache.appends")
        reg.inc("cache.bytes_written", len(line) + 1)

    def best(self, benchmark: str, direction: Direction,
             settings_key: Optional[str] = None,
             ) -> Optional[tuple[Config, float]]:
        """Best non-pruned cached (config, score) for warm-starting the
        incumbent. Pruned trials carry truncated estimates and never seed,
        and with ``settings_key`` neither do trials measured under other
        settings (e.g. a halving rung's reduced budget) — legacy records
        without a key still qualify."""
        with self._lock:
            if settings_key is not None:
                pool = [(cfg, res)
                        for (bench, _, skey), (cfg, res, _strat)
                        in self._entries.items()
                        if bench == benchmark
                        and skey in (None, settings_key)]
            else:
                pool = [(cfg, res)
                        for (bench, _), (cfg, res, *_meta)
                        in self._latest.items() if bench == benchmark]
            best: Optional[tuple[Config, float]] = None
            for cfg, res in pool:
                if res.pruned:
                    continue
                if best is None or direction.better(res.score, best[1]):
                    best = (cfg, res.score)
            return best

    def suggest_seeds(self, benchmark: str,
                      fingerprint: Optional[str] = None,
                      direction: Direction = Direction.MAXIMIZE,
                      limit: int = 3) -> list[Config]:
        """Transfer-tuning warm-start seeds: the best unpruned cached
        configurations of ``benchmark``, best first.

        With ``fingerprint=None`` (or this cache's own) the in-memory
        entries answer first; when they fill fewer than ``limit`` seeds,
        *donor* fingerprints found in the cache file top the list up —
        ranked by :meth:`rank_donors` (Spearman rank-correlation of
        shared-config scores against this machine, recency fallback), so
        machines that rank configurations the way this one does get their
        incumbents trusted first. An explicit foreign ``fingerprint``
        reads that single donor, since :class:`TrialCache` drops foreign
        records on load. Timings never transfer across hardware — but
        *configurations* are still informative starting points, which is
        all a seed is. Feed the result to ``Tuner.tune(seeds=...)``
        (configs are projected into the target space there).
        """
        if fingerprint is not None and fingerprint != self.fingerprint:
            pool = list(self._donor_pool(benchmark, fingerprint).values())
            pool.sort(key=lambda cr: cr[1].score,
                      reverse=(direction is Direction.MAXIMIZE))
            return [cfg for cfg, _ in pool[:max(0, limit)]]
        with self._lock:
            pool = [(cfg, res) for (bench, _), (cfg, res, *_meta)
                    in self._latest.items()
                    if bench == benchmark and not res.pruned]
        pool.sort(key=lambda cr: cr[1].score,
                  reverse=(direction is Direction.MAXIMIZE))
        seeds = [cfg for cfg, _ in pool[:max(0, limit)]]
        if len(seeds) >= limit:
            return seeds
        # top up from donor fingerprints: one file scan serves both the
        # ranking and the per-donor candidate pools
        pools, last_seen = self._donor_scan(benchmark)
        seen = {config_key(cfg) for cfg in seeds}
        for donor_fp, _rho in self._rank_donors(benchmark, pools, last_seen):
            donor = list(pools[donor_fp].values())
            donor.sort(key=lambda cr: cr[1].score,
                       reverse=(direction is Direction.MAXIMIZE))
            for cfg, _ in donor:
                key = config_key(cfg)
                if key in seen:
                    continue
                seen.add(key)
                seeds.append(cfg)
                if len(seeds) >= limit:
                    return seeds
        return seeds

    def _donor_pool(self, benchmark: str, fingerprint: str,
                    ) -> dict[str, tuple[Config, EvalResult]]:
        """Latest unpruned record per config of one foreign fingerprint,
        re-read from the cache file (foreign records are dropped on load)."""
        if not self.path.exists():
            return {}
        dedup: dict[str, tuple[Config, EvalResult]] = {}
        for t in iter_trials(self.path):
            if t.benchmark == benchmark and t.fingerprint == fingerprint \
                    and not t.result.pruned:
                dedup[t.key] = (t.config, t.result)
        return dedup

    def _donor_scan(self, benchmark: str,
                    ) -> tuple[dict[str, dict[str, tuple[Config, EvalResult]]],
                               dict[str, int]]:
        """Single pass over the cache file: every foreign fingerprint's
        latest unpruned record per config, plus each donor's last write
        position (the recency-ranking key)."""
        pools: dict[str, dict[str, tuple[Config, EvalResult]]] = {}
        last_seen: dict[str, int] = {}
        if not self.path.exists():
            return pools, last_seen
        for pos, t in enumerate(iter_trials(self.path)):
            if t.benchmark != benchmark or t.fingerprint == self.fingerprint \
                    or t.result.pruned:
                continue
            pools.setdefault(t.fingerprint, {})[t.key] = (t.config, t.result)
            last_seen[t.fingerprint] = pos
        return pools, last_seen

    def _rank_donors(self, benchmark: str,
                     pools: dict[str, dict[str, tuple[Config, EvalResult]]],
                     last_seen: dict[str, int],
                     min_overlap: int = 3,
                     ) -> list[tuple[str, Optional[float]]]:
        with self._lock:
            own = {ckey: res.score
                   for (bench, ckey), (_cfg, res, *_meta)
                   in self._latest.items()
                   if bench == benchmark and not res.pruned}
        correlated: list[tuple[str, float]] = []
        uncorrelated: list[str] = []
        for fp, entries in pools.items():
            shared = sorted(set(entries) & set(own))
            rho = (spearman([own[k] for k in shared],
                            [entries[k][1].score for k in shared])
                   if len(shared) >= min_overlap else None)
            if rho is None:
                uncorrelated.append(fp)
            else:
                correlated.append((fp, rho))
        correlated.sort(key=lambda fr: (-fr[1], -last_seen[fr[0]]))
        uncorrelated.sort(key=lambda fp: -last_seen[fp])
        return correlated + [(fp, None) for fp in uncorrelated]

    def rank_donors(self, benchmark: str,
                    min_overlap: int = 3,
                    ) -> list[tuple[str, Optional[float]]]:
        """Donor fingerprints for transfer seeding, most trustworthy first.

        A donor whose scores **rank** the shared configurations the same
        way this machine's do is likely to rank the unshared ones
        similarly too — so donors are ordered by Spearman rank-correlation
        of shared-config scores (descending), computed when at least
        ``min_overlap`` configs overlap with this fingerprint's own
        records. Donors below the overlap threshold (including every donor
        when this machine has no trials yet) keep the recency fallback:
        most recently written first. Returns ``(fingerprint, rho)`` pairs,
        ``rho=None`` for the recency-ordered tail.
        """
        pools, last_seen = self._donor_scan(benchmark)
        return self._rank_donors(benchmark, pools, last_seen,
                                 min_overlap=min_overlap)

    def bound(self, benchmark: str) -> "BoundCache":
        return BoundCache(self, benchmark)


class BoundCache:
    """A :class:`TrialCache` view fixed to one benchmark name — the shape
    ``Tuner.tune(cache=...)`` consumes."""

    def __init__(self, cache: TrialCache, benchmark: str):
        self.cache = cache
        self.benchmark = benchmark

    def get(self, config: Config,
            settings_key: Optional[str] = None) -> Optional[EvalResult]:
        return self.cache.get(self.benchmark, config,
                              settings_key=settings_key)

    def put(self, config: Config, result: EvalResult,
            strategy: Optional[str] = None,
            settings_key: Optional[str] = None) -> None:
        self.cache.put(self.benchmark, config, result, strategy=strategy,
                       settings_key=settings_key)

    def best(self, direction: Direction,
             settings_key: Optional[str] = None,
             ) -> Optional[tuple[Config, float]]:
        return self.cache.best(self.benchmark, direction,
                               settings_key=settings_key)

    def suggest_seeds(self, direction: Direction = Direction.MAXIMIZE,
                      limit: int = 3) -> list[Config]:
        return self.cache.suggest_seeds(self.benchmark, direction=direction,
                                        limit=limit)


#: Default sentinel for ``TuningSession(ledger=...)``: create/append the
#: shared run ledger next to the session caches (``<cache_dir>/history.jsonl``).
AUTO_LEDGER = object()


class TuningSession:
    """A named, resumable tuning run.

    ``run()`` executes the wrapped tuner with the session's cache: configs
    already on disk are served from the cache (no re-evaluation), fresh
    evaluations append as they finish, and the incumbent warm-starts from
    the best cached trial. Kill the process at any point and ``run()``
    again — it completes the remaining configs only.

    Every completed ``run()`` also appends one record to the
    performance-history **run ledger** (``<cache_dir>/history.jsonl`` by
    default — a shared longitudinal file, unlike the per-session trial
    caches), so drift across runs of the same benchmark × fingerprint is
    detectable later (``repro_torch.history``, ``python -m
    repro_torch.perf_gate``). Pass ``ledger=None`` to disable, or a
    :class:`~repro_torch.history.ledger.RunLedger` (or path) to redirect.

    ``trace=True`` records a span trace of every ``run()`` to
    ``<cache_dir>/<name>.trace.jsonl`` (a path redirects it); the result
    carries it as ``TuningResult.trace_path``. When a recorder is
    already installed (an enclosing campaign or test owns it), the
    session joins that trace instead of opening its own.
    """

    def __init__(self, name: str, tuner, benchmark,
                 cache_dir: str | os.PathLike = ".tuning_sessions",
                 warm_start: bool = True,
                 fingerprint: Optional[str] = None,
                 benchmark_name: Optional[str] = None,
                 ledger=AUTO_LEDGER,
                 campaign: Optional[str] = None,
                 trace: "bool | str | os.PathLike" = False):
        self.name = name
        self.tuner = tuner
        self.benchmark = benchmark
        # distinct cache namespace per objective: a session file reused with
        # a different benchmark must not warm-start across metrics
        self.benchmark_name = benchmark_name or name
        # sweep campaigns stamp their name on every ledger record so one
        # grid-tuning pass is recognizable as a unit in history tooling
        self.campaign = campaign
        self.warm_start = warm_start
        self.trace = trace
        self.trace_path: Optional[Path] = None
        if trace:
            self.trace_path = (Path(cache_dir) / f"{name}.trace.jsonl"
                               if trace is True else Path(trace))
        self.cache = TrialCache(Path(cache_dir) / f"{name}.jsonl",
                                fingerprint=fingerprint)
        if ledger is AUTO_LEDGER or isinstance(ledger, (str, os.PathLike)):
            # deferred import: the history layer depends on core
            from ..history.ledger import RunLedger
            path = (Path(cache_dir) / "history.jsonl"
                    if ledger is AUTO_LEDGER else ledger)
            ledger = RunLedger(path)
        self.ledger = ledger

    def run(self, backend=None, progress=None, seeds=(), timestamp=None,
            validate: str = "warn"):
        """Execute the wrapped tuner against the session cache. ``seeds``
        are transfer-tuning warm-start configs (see
        ``TrialCache.suggest_seeds``), forwarded to ``Tuner.tune``, as
        is ``validate`` (see ``Tuner.tune``). ``timestamp``
        (caller-supplied epoch seconds — core never reads a clock for
        records) stamps the ledger entry this run appends."""
        import contextlib

        bound_ledger = None
        if self.ledger is not None:
            bound_ledger = self.ledger.bound(self.benchmark_name,
                                             self.cache.fingerprint,
                                             session=self.name,
                                             campaign=self.campaign)
        with contextlib.ExitStack() as stack:
            if self.trace_path is not None:
                # deferred import + already-active check: an enclosing
                # campaign/test recorder wins, the session joins its trace
                from ..obs.trace import TraceRecorder, recorder
                if recorder() is None:
                    stack.enter_context(TraceRecorder(self.trace_path,
                                                      session=self.name))
            return self.tuner.tune(self.benchmark, progress=progress,
                                   backend=backend,
                                   cache=self.cache.bound(
                                       self.benchmark_name),
                                   warm_start=self.warm_start,
                                   seeds=seeds, ledger=bound_ledger,
                                   timestamp=timestamp, validate=validate)
