"""Phase-bucket profiling of the tuning harness itself.

The paper's 116x search-time win came from cutting *sample counts*; the
next order of magnitude is per-trial overhead, and you cannot cut what
you cannot see. This module is the minimal instrumentation layer the
harness self-benchmark activates to
attribute a tuning session's wall clock to phase buckets:

  ``setup``     invocation-factory work (data generation, pre-heat)
  ``compile``   kernel lowering + compilation (ExecutableCache misses)
  ``dispatch``  timed kernel work as seen by the samplers
  ``sync``      device synchronization at the end of a batched sample
  ``stats``     Welford updates + stop-condition evaluation
  ``cache_io``  trial-cache JSONL appends

Buckets may nest (a cache-served ``compile`` happens inside ``setup``);
each records its own wall time independently, so buckets are a
*profile*, not a partition: a harness benchmark derives its headline
non-measured metric from session wall clock and kernel-time references,
and uses these buckets to explain where the overhead went.

Instrumentation sites call :func:`phase`, which is a no-op (two global
reads, no allocation) unless a :class:`PhaseProfiler` *or* a trace sink
is installed — the hot per-sample paths stay hardware-fast when nobody
is watching.  Thread-safe: concurrent trials on the thread backend fold
into the same buckets under a lock.

The module is also the **dual-sink seam** for a span-trace recorder: a
recorder installs itself via :func:`set_trace_sink`, after which every
:func:`phase` site feeds both the aggregate buckets (when a profiler is
active) and a per-thread span in the trace — per-trial attribution the
folded buckets cannot give (:class:`repro_torch.obs.trace.TraceRecorder`).
With no recorder installed every trace helper here (:func:`trace_span`,
:func:`trace_instant`, :func:`record_phase`'s span half) is a no-op.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["PhaseProfiler", "PhaseStats", "phase", "profiler",
           "record_phase", "set_trace_sink", "trace_instant", "trace_sink",
           "trace_span"]


class PhaseStats:
    """Accumulated (wall seconds, enter count) of one bucket."""

    __slots__ = ("seconds", "count")

    def __init__(self):
        self.seconds = 0.0
        self.count = 0

    def to_json(self) -> dict:
        return {"seconds": self.seconds, "count": self.count}


class _NullPhase:
    """Shared no-op context manager returned when no sink is active."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return None


_NULL = _NullPhase()


class _Span:
    __slots__ = ("profiler", "name", "t0")

    def __init__(self, profiler: "PhaseProfiler", name: str):
        self.profiler = profiler
        self.name = name

    def __enter__(self):
        self.t0 = self.profiler.clock()
        return self

    def __exit__(self, *exc):
        self.profiler.add(self.name, self.profiler.clock() - self.t0)
        return False


class PhaseProfiler:
    """Collects phase buckets while installed as the active profiler.

    Use as a context manager (installation is process-global — one
    profiler at a time; nested installs raise)::

        prof = PhaseProfiler()
        with prof:
            tuner.tune(benchmark)
        print(prof.report())
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self._lock = threading.Lock()
        self._buckets: dict[str, PhaseStats] = {}

    # -- collection -----------------------------------------------------------
    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            st = self._buckets.get(name)
            if st is None:
                st = self._buckets[name] = PhaseStats()
            st.seconds += seconds
            st.count += 1

    def phase(self, name: str) -> _Span:
        return _Span(self, name)

    # -- reading --------------------------------------------------------------
    def buckets(self) -> dict[str, PhaseStats]:
        with self._lock:
            return dict(self._buckets)

    def to_json(self) -> dict:
        return {name: st.to_json()
                for name, st in sorted(self.buckets().items())}

    def report(self) -> str:
        rows = [f"  {name:<10s} {st.seconds * 1e3:9.3f} ms x{st.count}"
                for name, st in sorted(self.buckets().items())]
        return "harness phases:\n" + "\n".join(rows) if rows \
            else "harness phases: (empty)"

    # -- installation ---------------------------------------------------------
    def __enter__(self) -> "PhaseProfiler":
        global _ACTIVE
        with _INSTALL_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("a PhaseProfiler is already active")
            _ACTIVE = self
        return self

    def __exit__(self, *exc) -> bool:
        global _ACTIVE
        with _INSTALL_LOCK:
            _ACTIVE = None
        return False


_INSTALL_LOCK = threading.Lock()
_ACTIVE: Optional[PhaseProfiler] = None

# the installed trace recorder, or None; duck-typed so this module never
# has to import one
_TRACE = None


def profiler() -> Optional[PhaseProfiler]:
    """The currently installed profiler, or ``None``."""
    return _ACTIVE


def set_trace_sink(sink) -> None:
    """Install/clear the trace sink (called by a trace recorder)."""
    global _TRACE
    _TRACE = sink


def trace_sink():
    """The installed trace sink, or ``None`` when tracing is off."""
    return _TRACE


class _DualPhase:
    """One ``phase()`` site feeding bucket and/or span sinks."""

    __slots__ = ("name", "_prof", "_sink", "_span", "_bucket")

    def __init__(self, name: str, prof: Optional[PhaseProfiler], sink):
        self.name = name
        self._prof = prof
        self._sink = sink
        self._span = None
        self._bucket = None

    def __enter__(self):
        if self._prof is not None:
            self._bucket = self._prof.phase(self.name).__enter__()
        self._span = self._sink.span(self.name, cat="phase").__enter__()
        return self

    def set(self, **attrs):
        self._span.set(**attrs)

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        if self._bucket is not None:
            self._bucket.__exit__(*exc)
        return False


def phase(name: str):
    """Context manager timing one phase span; free when nobody watches.

    Dual-sink: feeds the active :class:`PhaseProfiler` buckets and the
    active trace sink's span tree, whichever (or both) is installed.
    """
    active = _ACTIVE
    sink = _TRACE
    if sink is None:
        if active is None:
            return _NULL
        return active.phase(name)
    return _DualPhase(name, active, sink)


def record_phase(name: str, seconds: float,
                 at: Optional[float] = None) -> None:
    """Record an interval the caller already measured, into both sinks.

    The samplers use this for their hot-loop deltas (clock readings are
    already taken; a context manager would add overhead).  ``at`` is the
    interval's end on ``time.perf_counter`` so adjacent phases land
    adjacent in the trace; ``None`` means "now".
    """
    active = _ACTIVE
    if active is not None:
        active.add(name, seconds)
    sink = _TRACE
    if sink is not None:
        sink.add_phase(name, seconds, at=at)


def trace_span(name: str, cat: str = "phase", *, context: bool = False,
               **attrs):
    """Open a span on the trace sink; shared no-op when tracing is off."""
    sink = _TRACE
    if sink is None:
        return _NULL
    return sink.span(name, cat=cat, context=context, **attrs)


def trace_instant(name: str, **attrs) -> None:
    """Emit an instant event on the trace sink, if one is installed."""
    sink = _TRACE
    if sink is not None:
        sink.instant(name, **attrs)
