"""Process-global metrics registry: named counters and gauges.

One lock-protected :class:`MetricsRegistry` per process (the
:func:`metrics` accessor), incremented from the hot paths that already
hold no other locks: trial start/finish in the executor backends, trial
cache appends, run-ledger appends, trace-event emission.  Sessions never
reset the registry — concurrent sessions share the process — instead
they take a :meth:`MetricsRegistry.snapshot` at ``tune()`` entry and
report the :meth:`MetricsRegistry.delta` against it, so back-to-back
sessions each see only their own activity (the same discipline
``ExecCacheStats.delta`` applies to the executable cache).

Counter names are dotted, lowercase, and stable once shipped:
``trials.started`` / ``trials.completed`` / ``trials.pruned`` /
``trials.cached``, ``exec_cache.hits`` / ``.misses`` / ``.compiles``,
``cache.appends`` / ``cache.bytes_written``, ``ledger.appends``,
``trace.events``.
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = ["MetricsRegistry", "metrics"]


class MetricsRegistry:
    """Thread-safe named counters and gauges."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}

    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> dict:
        """Point-in-time copy: ``{"counters": {...}, "gauges": {...}}``."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}

    def delta(self, since: Optional[dict] = None) -> dict:
        """Counters advanced since ``since`` (a prior :meth:`snapshot`).

        Only counters that moved appear; gauges report their current
        value.  ``since=None`` degrades to a full snapshot.
        """
        cur = self.snapshot()
        base = (since or {}).get("counters", {})
        counters = {k: v - base.get(k, 0)
                    for k, v in cur["counters"].items()
                    if v != base.get(k, 0)}
        return {"counters": counters, "gauges": cur["gauges"]}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


_GLOBAL: Optional[MetricsRegistry] = None
_GLOBAL_LOCK = threading.Lock()


def metrics() -> MetricsRegistry:
    """The process-global registry (created on first use)."""
    global _GLOBAL
    reg = _GLOBAL
    if reg is None:
        with _GLOBAL_LOCK:
            reg = _GLOBAL
            if reg is None:
                reg = _GLOBAL = MetricsRegistry()
    return reg
