"""Span-based trial tracing to an append-only JSONL event log.

The span tree is ``session → shape → trial → invocation → phase``;
instant events mark incumbent improvements, CI prunes, trial-cache hits
and executable-cache hits/dedups.  Parent attribution is what
``PhaseProfiler`` cannot do: the profiler folds every worker thread into
global buckets, while the recorder keeps a **per-thread span stack**
(trial spans opened on a pool thread nest correctly under each other)
plus a cross-thread **context stack** for spans whose children are
opened on *other* threads — the session span is pushed as context by the
scheduling thread, so a trial span opened on a worker thread with an
empty local stack still parents to it.

Records are one JSON object per line, written (and flushed) at span
*end*, so children always precede their parents in the file and a torn
tail line loses at most one record:

``{"type": "span", "id": 7, "parent": 1, "name": "trial", "cat":
"trial", "ts": 0.0123, "dur": 0.0041, "tid": 1234, "thread":
"ThreadPoolExecutor-0_1", "attrs": {...}}``

``ts``/``dur`` are seconds relative to recorder start on the monotonic
clock.  ``{"type": "instant", ...}`` carries ``ts`` but no duration;
``{"type": "meta", ...}`` carries free-form metadata (one is written at
install with the trace version, another typically at session end with
the metrics snapshot).

Installing the recorder (``with TraceRecorder(...)``) wires it into
``repro_torch.core.profiling`` as the trace sink, which turns every
existing ``phase()`` call site in the evaluator/samplers/exec-cache into
a dual-sink (bucket + span) with the same no-op fast path when nothing is
installed.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

from .metrics import metrics

TRACE_VERSION = 1

__all__ = ["TRACE_VERSION", "TraceRecorder", "recorder"]

_INSTALL_LOCK = threading.Lock()
_ACTIVE: Optional["TraceRecorder"] = None


def recorder() -> Optional["TraceRecorder"]:
    """The installed recorder, or ``None`` when tracing is off."""
    return _ACTIVE


class _SpanHandle:
    """An open span; exiting the context manager completes it."""

    __slots__ = ("_rec", "id", "parent", "name", "cat", "attrs",
                 "_t0", "_tid", "_thread", "_context")

    def __init__(self, rec: "TraceRecorder", sid: int, parent: Optional[int],
                 name: str, cat: str, t0: float, attrs: dict,
                 context: bool, tid: int, thread: str) -> None:
        self._rec = rec
        self.id = sid
        self.parent = parent
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self._t0 = t0
        self._tid = tid
        self._thread = thread
        self._context = context

    def set(self, **attrs: Any) -> None:
        """Attach attributes resolved mid-span (score, prune reason, ...)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, *exc) -> bool:
        self._rec._end(self)
        return False


class TraceRecorder:
    """Collects spans/instants in memory and appends them to JSONL.

    ``path=None`` keeps the trace purely in memory (tests, ad-hoc use);
    otherwise every completed record is appended and flushed so a
    crashed session still leaves a readable prefix.  Install with
    ``with`` — only one recorder may be active per process.
    """

    def __init__(self, path: Optional[str | Path] = None, *,
                 session: Optional[str] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 meta: Optional[dict] = None) -> None:
        self.path = Path(path) if path is not None else None
        self.session = session
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._n = 0
        self._events: list[dict] = []
        self._tls = threading.local()
        self._ctx: list[int] = []  # cross-thread parent defaults
        self._file = None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._file = open(self.path, "a", encoding="utf-8")
        head = {"type": "meta", "trace_version": TRACE_VERSION}
        if session is not None:
            head["session"] = session
        if meta:
            head.update(meta)
        self._emit(head)

    # -- span API ---------------------------------------------------------

    def span(self, name: str, cat: str = "phase", *, context: bool = False,
             **attrs: Any) -> _SpanHandle:
        """Open a span parented to this thread's innermost open span.

        With an empty local stack the span parents to the top of the
        context stack instead (how worker-thread trials attach to the
        session).  ``context=True`` additionally pushes the new span
        onto the context stack until it ends.
        """
        t0 = self._clock()
        th = threading.current_thread()
        stack = self._stack()
        with self._lock:
            self._n += 1
            sid = self._n
            parent = stack[-1].id if stack else (
                self._ctx[-1] if self._ctx else None)
            if context:
                self._ctx.append(sid)
        h = _SpanHandle(self, sid, parent, name, cat, t0, dict(attrs),
                        context, th.ident or 0, th.name)
        stack.append(h)
        return h

    def instant(self, name: str, **attrs: Any) -> None:
        """A zero-duration marker parented like :meth:`span`."""
        ts = self._clock() - self._t0
        th = threading.current_thread()
        stack = self._stack()
        with self._lock:
            parent = stack[-1].id if stack else (
                self._ctx[-1] if self._ctx else None)
        rec = {"type": "instant", "name": name, "parent": parent,
               "ts": round(ts, 9), "tid": th.ident or 0, "thread": th.name}
        if attrs:
            rec["attrs"] = attrs
        self._emit(rec)

    def add_phase(self, name: str, seconds: float,
                  at: Optional[float] = None) -> None:
        """Record an already-measured phase interval as a completed span.

        ``at`` is the interval's *end* on the recorder's clock (defaults
        to now); samplers that already hold clock readings pass it so
        back-to-back phases (dispatch then sync) land adjacent rather
        than overlapping.
        """
        end = at if at is not None else self._clock()
        th = threading.current_thread()
        stack = self._stack()
        with self._lock:
            self._n += 1
            sid = self._n
            parent = stack[-1].id if stack else (
                self._ctx[-1] if self._ctx else None)
        self._emit({"type": "span", "id": sid, "parent": parent,
                    "name": name, "cat": "phase",
                    "ts": round(end - self._t0 - seconds, 9),
                    "dur": round(max(seconds, 0.0), 9),
                    "tid": th.ident or 0, "thread": th.name})

    def meta_event(self, **fields: Any) -> None:
        """Append a free-form metadata record (metrics snapshots etc.)."""
        self._emit({"type": "meta", **fields})

    def events(self) -> list[dict]:
        """Copy of every record emitted so far (meta + spans + instants)."""
        with self._lock:
            return list(self._events)

    # -- internals --------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _end(self, h: _SpanHandle) -> None:
        t1 = self._clock()
        stack = self._stack()
        if stack and stack[-1] is h:
            stack.pop()
        elif h in stack:  # pragma: no cover - misnested exit, stay sane
            stack.remove(h)
        if h._context:
            with self._lock:
                if h.id in self._ctx:
                    self._ctx.remove(h.id)
        rec = {"type": "span", "id": h.id, "parent": h.parent,
               "name": h.name, "cat": h.cat,
               "ts": round(h._t0 - self._t0, 9),
               "dur": round(max(t1 - h._t0, 0.0), 9),
               "tid": h._tid, "thread": h._thread}
        if h.attrs:
            rec["attrs"] = h.attrs
        self._emit(rec)

    def _emit(self, rec: dict) -> None:
        line = json.dumps(rec, default=str)
        with self._lock:
            self._events.append(rec)
            if self._file is not None:
                self._file.write(line + "\n")
                self._file.flush()
        metrics().inc("trace.events")

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    # -- install ----------------------------------------------------------

    def __enter__(self) -> "TraceRecorder":
        global _ACTIVE
        from ..core import profiling  # runtime import; no cycle
        with _INSTALL_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("a TraceRecorder is already installed")
            _ACTIVE = self
            profiling.set_trace_sink(self)
        return self

    def __exit__(self, *exc) -> bool:
        global _ACTIVE
        from ..core import profiling
        with _INSTALL_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None
                profiling.set_trace_sink(None)
        self.close()
        return False
