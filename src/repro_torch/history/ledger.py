"""Append-only JSONL run ledger: one record per completed tuning session.

The trial cache (:mod:`repro_torch.core.cache`) remembers every *trial*; the
ledger remembers every *run* — the distilled outcome of one tuning session
on one benchmark × hardware fingerprint. That is the unit longitudinal
analysis wants: "has this machine's measured DGEMM peak drifted since last
week?" is a question about a sequence of incumbents, not about the 96
trials behind each one.

Records carry the incumbent configuration, its exact pooled Welford
moments ``(count, mean, m2)`` (merged from the stored per-invocation
moments with the Chan et al. combiner, so report-time CIs equal the
evaluator's), the per-invocation means (the low-n bootstrap fallback in
:mod:`~repro_torch.history.regression` resamples these), the producing strategy
and ``settings_key``, and a **monotonically-assigned run index** per
(benchmark, fingerprint) series. Timestamps are supplied by callers and
never read inside core — the ledger itself is clock-free and fully
deterministic, which keeps golden-file tests and resumed sessions honest.

Ledger records deliberately do **not** carry the trial cache's
``"version"`` key (they use ``"ledger_version"``), so a ledger file
sitting next to session caches is silently skipped by
:func:`repro_torch.core.cache.iter_trials` instead of crashing it — and vice
versa: cache records lack ``"ledger_version"`` and are skipped here.

On-disk format: ``docs/history.md``, byte for byte the JAX package's, so
a ledger written by either package reads in the other.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
from pathlib import Path
from typing import Iterator, Optional

from ..core import welford
from ..core.cache import config_key
from ..core.searchspace import Config
from ..core.stop_conditions import Direction
from ..core.welford import WelfordState
from ..obs.metrics import metrics as obs_metrics

__all__ = ["LEDGER_VERSION", "BoundLedger", "RunLedger", "RunRecord",
           "iter_runs", "record_from_result"]

LEDGER_VERSION = 1


@dataclasses.dataclass(frozen=True)
class RunRecord:
    """One completed tuning session's distilled outcome."""

    benchmark: str
    fingerprint: str
    run: int                       # monotonic index within the series
    config: Config                 # the incumbent configuration
    score: float                   # incumbent score (mean of invocation means)
    count: float                   # pooled Welford moments of the incumbent's
    mean: float                    # sample stream (exact merge of the stored
    m2: float                      # per-invocation moments)
    invocation_means: tuple[float, ...] = ()   # low-n bootstrap fallback input
    strategy: Optional[str] = None
    settings_key: Optional[str] = None
    direction: str = Direction.MAXIMIZE.value
    n_trials: int = 0              # trials the session evaluated (incl. cached)
    total_samples: int = 0         # samples across the whole session
    session: Optional[str] = None  # TuningSession name, when one ran it
    campaign: Optional[str] = None  # sweep campaign name, when one ran it
    timestamp: Optional[float] = None   # caller-supplied epoch seconds

    @property
    def state(self) -> WelfordState:
        """The incumbent's pooled sample moments as a WelfordState."""
        return WelfordState(count=self.count, mean=self.mean, m2=self.m2)

    @property
    def key(self) -> tuple[str, str]:
        return (self.benchmark, self.fingerprint)


def record_from_result(benchmark: str, fingerprint: str, result,
                       settings_key: Optional[str] = None,
                       session: Optional[str] = None,
                       timestamp: Optional[float] = None,
                       direction: Direction = Direction.MAXIMIZE,
                       campaign: Optional[str] = None,
                       ) -> Optional[RunRecord]:
    """Distill a :class:`~repro_torch.core.tuner.TuningResult` into a run record
    (run index 0 — :meth:`RunLedger.append` assigns the real one).

    Returns ``None`` when the result has no incumbent, or when the
    incumbent's trial record cannot be found (nothing to pool moments
    from) — a run with nothing to remember is not recorded.
    """
    if result.best_config is None:
        return None
    want = config_key(result.best_config)
    trial = None
    for t in result.trials:
        if config_key(t.config) == want:
            trial = t   # last evaluation of the incumbent config wins
    if trial is None:
        return None
    pooled = welford.tree_merge([
        WelfordState(count=float(i.count), mean=i.mean, m2=i.m2)
        for i in trial.result.invocations])
    return RunRecord(
        benchmark=benchmark, fingerprint=fingerprint, run=0,
        config=result.best_config, score=result.best_score,
        count=float(pooled.count), mean=float(pooled.mean),
        m2=float(pooled.m2),
        invocation_means=tuple(i.mean for i in trial.result.invocations),
        strategy=getattr(result, "strategy", None),
        settings_key=settings_key,
        direction=direction.value,
        n_trials=len(result.trials),
        total_samples=result.total_samples,
        session=session, campaign=campaign, timestamp=timestamp)


def _record_to_json(rec: RunRecord) -> dict:
    d = {"ledger_version": LEDGER_VERSION,
         "benchmark": rec.benchmark, "fingerprint": rec.fingerprint,
         "run": rec.run, "config": rec.config, "score": rec.score,
         "count": rec.count, "mean": rec.mean, "m2": rec.m2,
         "invocation_means": list(rec.invocation_means),
         "direction": rec.direction,
         "n_trials": rec.n_trials, "total_samples": rec.total_samples}
    for field in ("strategy", "settings_key", "session", "campaign",
                  "timestamp"):
        value = getattr(rec, field)
        if value is not None:
            d[field] = value
    return d


def _record_from_json(d: dict) -> RunRecord:
    return RunRecord(
        benchmark=d["benchmark"], fingerprint=d["fingerprint"],
        run=int(d["run"]), config=d["config"], score=d["score"],
        count=float(d["count"]), mean=float(d["mean"]), m2=float(d["m2"]),
        invocation_means=tuple(d.get("invocation_means", ())),
        strategy=d.get("strategy"), settings_key=d.get("settings_key"),
        direction=d.get("direction", Direction.MAXIMIZE.value),
        n_trials=int(d.get("n_trials", 0)),
        total_samples=int(d.get("total_samples", 0)),
        session=d.get("session"), campaign=d.get("campaign"),
        timestamp=d.get("timestamp"))


def iter_runs(path: str | os.PathLike) -> Iterator[RunRecord]:
    """Yield every readable run record in a ledger file, in file order.

    Tolerates a torn trailing line; skips records whose
    ``ledger_version`` mismatches (including trial-cache records, which
    carry no ``ledger_version`` at all).
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
            if rec.get("ledger_version") != LEDGER_VERSION:
                continue
            yield _record_from_json(rec)


class RunLedger:
    """Thread-safe append-only JSONL store of completed runs.

    Run indices are assigned at append time: the next integer after the
    highest existing index of the record's (benchmark, fingerprint)
    series — monotone per series regardless of interleaving with other
    series in the same file.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self._lock = threading.Lock()
        self._series: dict[tuple[str, str], list[RunRecord]] = {}
        if self.path.exists():
            for rec in iter_runs(self.path):
                self._series.setdefault(rec.key, []).append(rec)
            for runs in self._series.values():
                runs.sort(key=lambda r: r.run)

    def __len__(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._series.values())

    def keys(self) -> list[tuple[str, str]]:
        """Every (benchmark, fingerprint) series with at least one run."""
        with self._lock:
            return sorted(self._series)

    def series(self, benchmark: str, fingerprint: str) -> list[RunRecord]:
        """All runs of one series, run-index order."""
        with self._lock:
            return list(self._series.get((benchmark, fingerprint), ()))

    def append(self, record: RunRecord) -> RunRecord:
        """Persist a record, assigning the series' next run index (the
        caller's ``run`` field is ignored). Returns the stored record.

        The index is the successor of the highest one visible in memory
        *or on disk*: the file is re-read here (appends are rare — one
        per completed session) under an exclusive advisory ``flock`` held
        across the read **and** the write, so two processes sharing a
        ledger cannot both observe index N and append N+1. On platforms
        without ``fcntl`` the lock degrades to read-then-append, which
        still heals stale in-process snapshots but leaves a narrow
        cross-process race.
        """
        try:
            import fcntl
        except ImportError:              # pragma: no cover - non-POSIX
            fcntl = None
        with self._lock:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with self._locked_file(fcntl) as f:
                try:
                    runs = self._series.setdefault(record.key, [])
                    last = runs[-1].run if runs else -1
                    f.seek(0)
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        if rec.get("ledger_version") != LEDGER_VERSION:
                            continue
                        if (rec.get("benchmark"), rec.get("fingerprint")) \
                                == record.key:
                            last = max(last, int(rec.get("run", -1)))
                    record = dataclasses.replace(record, run=last + 1)
                    f.seek(0, os.SEEK_END)
                    f.write(json.dumps(_record_to_json(record), default=str)
                            + "\n")
                    f.flush()
                finally:
                    if fcntl is not None:
                        fcntl.flock(f.fileno(), fcntl.LOCK_UN)
            runs.append(record)
        obs_metrics().inc("ledger.appends")
        return record

    @contextlib.contextmanager
    def _locked_file(self, fcntl):
        """Open the ledger ``a+`` holding the exclusive advisory flock.

        After acquiring the lock the inode is re-checked against the
        path: a concurrent :meth:`compact` may have atomically replaced
        the file between our ``open`` and ``flock``, and appending to the
        orphaned inode would silently lose the record. Stale handles are
        re-opened until the lock is held on the live file."""
        while True:
            f = open(self.path, "a+", encoding="utf-8")
            if fcntl is None:            # pragma: no cover - non-POSIX
                break
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            try:
                if os.fstat(f.fileno()).st_ino == os.stat(self.path).st_ino:
                    break
            except OSError:
                pass                     # path vanished mid-race: reopen
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)
            f.close()
        try:
            yield f
        finally:
            f.close()

    def compact(self, keep_last: int = 20) -> int:
        """Drop superseded non-best runs past a per-series cap.

        Multi-year deployments append one record per completed session
        forever; most of those records are neither recent (trend
        dashboards window them out) nor the series' best (the regression
        baseline). For every (benchmark, fingerprint) series this keeps
        the most recent ``keep_last`` runs **plus the best run ever**
        (by each record's own recorded direction — the baseline
        ``detect_regressions`` compares against must survive) and drops
        the rest. Run indices are preserved, never renumbered, so a
        later ``append`` continues the series where it left off and
        trend x-axes stay stable across compactions. Foreign lines
        (other ledger versions, torn writes) are preserved verbatim.

        The rewrite is atomic under the same exclusive ``flock`` that
        serializes :meth:`append`: the survivors are written to a temp
        file in the ledger's directory, fsynced, and ``os.replace``d
        over the ledger while the lock is held — a crash mid-compaction
        leaves the original file intact, and a concurrent appender
        re-checks its inode after locking so it never writes to the
        orphaned file. Returns the number of run records dropped.
        """
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        try:
            import fcntl
        except ImportError:              # pragma: no cover - non-POSIX
            fcntl = None
        with self._lock:
            if not self.path.exists():
                return 0
            with self._locked_file(fcntl) as f:
                f.seek(0)
                lines = f.read().splitlines()
                parsed: list[tuple[str, Optional[RunRecord]]] = []
                series: dict[tuple[str, str], list[RunRecord]] = {}
                for line in lines:
                    if not line.strip():
                        continue
                    rec = None
                    try:
                        d = json.loads(line)
                        if d.get("ledger_version") == LEDGER_VERSION:
                            rec = _record_from_json(d)
                    except (json.JSONDecodeError, KeyError, TypeError,
                            ValueError):
                        rec = None       # foreign/torn: preserved verbatim
                    parsed.append((line, rec))
                    if rec is not None:
                        series.setdefault(rec.key, []).append(rec)
                keep: set[int] = set()
                for runs in series.values():
                    runs.sort(key=lambda r: r.run)
                    best = runs[0]
                    for r in runs[1:]:
                        direction = Direction(r.direction)
                        if direction.better(r.score, best.score):
                            best = r
                    chosen = {id(r) for r in runs[-keep_last:]}
                    chosen.add(id(best))
                    keep.update(chosen)
                survivors = [(line, rec) for line, rec in parsed
                             if rec is None or id(rec) in keep]
                dropped = len(parsed) - len(survivors)
                if dropped:
                    tmp = self.path.with_name(self.path.name + ".compact")
                    with open(tmp, "w", encoding="utf-8") as out:
                        out.write("".join(line + "\n"
                                          for line, _ in survivors))
                        out.flush()
                        os.fsync(out.fileno())
                    os.replace(tmp, self.path)
                self._series = {
                    key: sorted((r for r in runs
                                 if id(r) in keep), key=lambda r: r.run)
                    for key, runs in series.items()}
                self._series = {k: v for k, v in self._series.items() if v}
                if fcntl is not None:
                    fcntl.flock(f.fileno(), fcntl.LOCK_UN)
            return dropped

    def record_result(self, benchmark: str, fingerprint: str, result,
                      settings_key: Optional[str] = None,
                      session: Optional[str] = None,
                      timestamp: Optional[float] = None,
                      direction: Direction = Direction.MAXIMIZE,
                      campaign: Optional[str] = None,
                      ) -> Optional[RunRecord]:
        """Distill and append a :class:`TuningResult`; returns the stored
        record, or ``None`` when the result has no incumbent."""
        rec = record_from_result(benchmark, fingerprint, result,
                                 settings_key=settings_key,
                                 session=session, timestamp=timestamp,
                                 direction=direction, campaign=campaign)
        return self.append(rec) if rec is not None else None

    def backfill(self, cache, session: Optional[str] = None,
                 direction: Direction = Direction.MAXIMIZE,
                 ) -> list[RunRecord]:
        """Seed the ledger from an existing trial cache: one run per
        (benchmark, fingerprint) the cache holds unpruned trials for —
        its incumbent, selected exactly like ``TrialCache.best`` under
        ``direction`` (the cache itself does not record which way its
        scores point, so minimize-direction archives must say so here) —
        but only for series the ledger has **no** runs of yet
        (idempotent: a second backfill of the same cache appends nothing).

        ``cache`` is a :class:`~repro_torch.core.cache.TrialCache`, a cache
        file path, or a directory of session caches.
        """
        from ..core.cache import TrialCache, load_trials
        if isinstance(cache, TrialCache):
            trials = cache.trials()
        else:
            trials = load_trials(cache)
        best: dict[tuple[str, str], object] = {}
        for t in trials:
            if t.result.pruned:
                continue
            prev = best.get((t.benchmark, t.fingerprint))
            if prev is None or direction.better(t.result.score,
                                                prev.result.score):
                best[(t.benchmark, t.fingerprint)] = t
        added = []
        for (bench, fp), t in sorted(best.items()):
            if self.series(bench, fp):
                continue
            pooled = welford.tree_merge([
                WelfordState(count=float(i.count), mean=i.mean, m2=i.m2)
                for i in t.result.invocations])
            added.append(self.append(RunRecord(
                benchmark=bench, fingerprint=fp, run=0, config=t.config,
                score=t.result.score, count=float(pooled.count),
                mean=float(pooled.mean), m2=float(pooled.m2),
                invocation_means=tuple(i.mean
                                       for i in t.result.invocations),
                strategy=t.strategy, direction=direction.value, n_trials=0,
                total_samples=t.result.total_samples, session=session)))
        return added

    def bound(self, benchmark: str, fingerprint: str,
              session: Optional[str] = None,
              campaign: Optional[str] = None) -> "BoundLedger":
        return BoundLedger(self, benchmark, fingerprint, session=session,
                           campaign=campaign)


class BoundLedger:
    """A :class:`RunLedger` view fixed to one (benchmark, fingerprint)
    series — the shape ``Tuner.tune(ledger=...)`` consumes (mirroring
    ``BoundCache``)."""

    def __init__(self, ledger: RunLedger, benchmark: str, fingerprint: str,
                 session: Optional[str] = None,
                 campaign: Optional[str] = None):
        self.ledger = ledger
        self.benchmark = benchmark
        self.fingerprint = fingerprint
        self.session = session
        self.campaign = campaign

    def record(self, result, settings_key: Optional[str] = None,
               timestamp: Optional[float] = None,
               direction: Direction = Direction.MAXIMIZE,
               ) -> Optional[RunRecord]:
        return self.ledger.record_result(
            self.benchmark, self.fingerprint, result,
            settings_key=settings_key, session=self.session,
            timestamp=timestamp, direction=direction,
            campaign=self.campaign)

    def series(self) -> list[RunRecord]:
        return self.ledger.series(self.benchmark, self.fingerprint)
