"""Resolve-once kernel cache + pipelined background preparation.

Short trials must not pay kernel preparation again on every outer-loop
invocation. This module makes it a *once per (kernel, config, shape,
dtype, device)* cost:

  * :class:`ExecutableCache` — resolves a kernel once for a static
    config and operand signature and serves the result to every later
    invocation. For a hand-written kernel (a wrapper carrying a
    ``resolve`` attribute, see :mod:`repro_torch.kernels`) resolving
    checks the static tile config against the kernel's table and, on the
    first miss, builds the kernel library; a plain PyTorch callable is
    served as it is (bound to its static keywords). Keys combine the
    kernel's identity, the static (config) arguments, every operand's
    shape/dtype/device, and the hardware fingerprint of that device — a
    shape or dtype change is a different entry, exactly like the trial
    cache's keying. Thread-safe with per-key in-flight deduplication: two
    threads racing on the same key resolve exactly once (the loser
    waits).
  * :class:`CompilePipeline` — a background worker. The engine feeds it
    the strategy's pending batch, so trial k+1's kernel is prepared while
    trial k runs — build latency overlaps measurement on the serial and
    thread backends instead of extending the critical path.

Operands may be real tensors or :class:`TensorSpec`s (shape, dtype and
device only — nothing is allocated), the counterpart of
``jax.ShapeDtypeStruct``. Nothing is compiled through ``torch.compile``.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Mapping, Optional, Sequence

from .profiling import phase, trace_instant

__all__ = ["CompilePipeline", "ExecCacheStats", "ExecutableCache",
           "TensorSpec", "default_cache"]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape, dtype and device of an operand that need not exist yet."""

    shape: tuple
    dtype: Any
    device: str = "cuda"


def _arg_key(a: Any) -> tuple:
    """Shape/dtype/device key of one operand (tensor or TensorSpec);
    plain Python scalars key on their type."""
    shape = getattr(a, "shape", None)
    dtype = getattr(a, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype), str(getattr(a, "device", "")))
    return ("pytype", type(a).__name__)


def _device_kind(args: Sequence[Any]) -> Optional[str]:
    """Device type ("cuda", "cpu") of the first operand that has one."""
    for a in args:
        device = getattr(a, "device", None)
        if device is not None:
            return str(device).split(":")[0]
    return None


def _static_key(static: Optional[Mapping[str, Any]]) -> tuple:
    if not static:
        return ()
    return tuple(sorted((k, repr(v)) for k, v in static.items()))


class ExecCacheStats:
    """Point-in-time snapshot of an :class:`ExecutableCache`'s counters."""

    __slots__ = ("hits", "misses", "compiles", "evictions", "compile_time_s",
                 "size")

    def __init__(self, hits: int, misses: int, compiles: int,
                 evictions: int, compile_time_s: float, size: int):
        self.hits = hits
        self.misses = misses
        self.compiles = compiles
        self.evictions = evictions
        self.compile_time_s = compile_time_s
        self.size = size

    def to_json(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "compiles": self.compiles, "evictions": self.evictions,
                "compile_time_s": self.compile_time_s, "size": self.size}

    def delta(self, since: "ExecCacheStats") -> "ExecCacheStats":
        """Counter movement between two snapshots of the *same* cache.

        ``size`` stays absolute (it is a level, not a counter).  This is
        how sessions report per-session cache activity without resetting
        the process-global cache under concurrent sessions: snapshot at
        ``tune()`` entry, ``stats.delta(entry_snapshot)`` at exit.
        """
        return ExecCacheStats(
            hits=self.hits - since.hits,
            misses=self.misses - since.misses,
            compiles=self.compiles - since.compiles,
            evictions=self.evictions - since.evictions,
            compile_time_s=self.compile_time_s - since.compile_time_s,
            size=self.size)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ExecCacheStats(hits={self.hits}, misses={self.misses}, "
                f"compiles={self.compiles}, evictions={self.evictions}, "
                f"size={self.size})")


class _Entry:
    """One cache slot; ``ready`` gates waiters while the owner compiles."""

    __slots__ = ("ready", "executable", "error", "fn")

    def __init__(self, fn: Callable):
        self.ready = threading.Event()
        self.executable = None
        self.error: Optional[BaseException] = None
        self.fn = fn         # strong ref: keeps id(fn) stable while cached


class ExecutableCache:
    """LRU cache of resolved kernels (see module docstring).

    ``capacity`` bounds the number of live entries — an unbounded cache
    would grow with every (config, shape) a campaign touches. Eviction is
    least-recently-used and never evicts an entry still resolving.
    ``fingerprint`` pins the device part of every key (tests); by default
    it is the hardware fingerprint of the operands' device.
    """

    def __init__(self, capacity: int = 256,
                 fingerprint: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._fingerprint = fingerprint
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._compiles = 0
        self._evictions = 0
        self._compile_time_s = 0.0

    # -- keying ---------------------------------------------------------------
    def _device_fingerprint(self, args: Sequence[Any]) -> str:
        if self._fingerprint is not None:
            return self._fingerprint
        kind = _device_kind(args)
        if kind is None:
            return "none"
        from .cache import hardware_fingerprint
        return hardware_fingerprint(kind)

    def key_for(self, fn: Callable, args: Sequence[Any],
                static: Optional[Mapping[str, Any]] = None) -> tuple:
        """The cache key: kernel identity x static config x operand
        shapes/dtypes/devices x device fingerprint."""
        ident = (getattr(fn, "__module__", ""),
                 getattr(fn, "__qualname__", repr(fn)), id(fn))
        return (ident, _static_key(static),
                tuple(_arg_key(a) for a in args),
                self._device_fingerprint(args))

    # -- the cache ------------------------------------------------------------
    def compile(self, fn: Callable, args: Sequence[Any],
                static: Optional[Mapping[str, Any]] = None):
        """The callable that runs ``fn`` at these operands and ``static``.

        ``args`` are example operands — tensors or :class:`TensorSpec`s
        (nothing is executed). ``static`` holds config keywords bound
        into the result (tile sizes, flags). The first call per key
        resolves (building the kernel library if this is the first hand
        kernel the process needs); every later call (any thread) returns
        the same callable.
        """
        key = self.key_for(fn, args, static)
        owner = False
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self._hits += 1
            else:
                entry = _Entry(fn)
                self._entries[key] = entry
                self._misses += 1
                owner = True
        if not owner:
            if entry.ready.is_set():
                trace_instant("exec_cache_hit",
                              fn=getattr(fn, "__qualname__", repr(fn)))
            else:                  # racing a compile in flight: dedup-wait
                trace_instant("exec_cache_dedup",
                              fn=getattr(fn, "__qualname__", repr(fn)))
            entry.ready.wait()     # hit, possibly still compiling elsewhere
            if entry.error is not None:
                raise entry.error
            return entry.executable
        try:
            with phase("compile"):
                t0 = time.perf_counter()
                entry.executable = self._resolve(fn, args, static)
                dt = time.perf_counter() - t0
            with self._lock:
                self._compiles += 1
                self._compile_time_s += dt
        except BaseException as e:
            entry.error = e
            with self._lock:
                self._entries.pop(key, None)   # failed keys retry next time
            raise
        finally:
            entry.ready.set()
        self._evict()
        return entry.executable

    @staticmethod
    def _resolve(fn: Callable, args: Sequence[Any],
                 static: Optional[Mapping[str, Any]]) -> Callable:
        kw = dict(static) if static else {}
        resolve = getattr(fn, "resolve", None)
        if resolve is not None:           # a hand kernel's wrapper
            return resolve(args, **kw)
        return functools.partial(fn, **kw) if kw else fn

    def _evict(self) -> None:
        with self._lock:
            while len(self._entries) > self.capacity:
                victim = None
                for k, e in self._entries.items():
                    if e.ready.is_set():
                        victim = k
                        break
                if victim is None:        # everything still compiling
                    break
                del self._entries[victim]
                self._evictions += 1

    # -- introspection --------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries

    @property
    def stats(self) -> ExecCacheStats:
        with self._lock:
            return ExecCacheStats(self._hits, self._misses, self._compiles,
                                  self._evictions, self._compile_time_s,
                                  len(self._entries))

    def clear(self) -> None:
        """Drop every executable (counters survive — they are totals)."""
        with self._lock:
            self._entries.clear()


_DEFAULT: Optional[ExecutableCache] = None
_DEFAULT_LOCK = threading.Lock()


def default_cache() -> ExecutableCache:
    """The process-wide shared cache the benchmark factories use, so every
    session in one process reuses each other's resolved kernels."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = ExecutableCache()
        return _DEFAULT


class CompilePipeline:
    """Background compile worker overlapping compilation with measurement.

    The engine submits one zero-arg *precompile task* per pending trial
    (derived from the benchmark's ``precompile(config)`` hook, which
    warms the :class:`ExecutableCache` from :class:`TensorSpec`s — no
    data is allocated). A single daemon worker drains the queue in
    proposal order, so while trial k runs on the measurement thread,
    trial k+1's kernel is already being prepared. The cache's in-flight
    deduplication guarantees a trial that overtakes the worker waits on
    — rather than duplicates — its compile.

    Task failures are recorded, not raised: a broken precompile surfaces
    on the trial itself with full context.
    """

    def __init__(self, name: str = "compile-pipeline"):
        self.name = name
        self._queue: list[Callable[[], None]] = []
        self._cv = threading.Condition()
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    def _ensure_worker(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run,
                                            name=self.name, daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                task = self._queue.pop(0)
            try:
                task()
            except Exception:
                with self._cv:
                    self._failed += 1
            else:
                with self._cv:
                    self._completed += 1
            with self._cv:
                self._cv.notify_all()

    def submit(self, task: Callable[[], None]) -> None:
        """Enqueue one precompile task (FIFO)."""
        with self._cv:
            if self._closed:
                raise RuntimeError("pipeline is closed")
            self._queue.append(task)
            self._submitted += 1
            self._cv.notify_all()
        self._ensure_worker()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted task finished; False on timeout."""
        with self._cv:
            return self._cv.wait_for(
                lambda: self._completed + self._failed == self._submitted,
                timeout=timeout)

    def close(self, wait: bool = True) -> None:
        """Stop accepting tasks; optionally wait for the queue to drain."""
        with self._cv:
            self._closed = True
            if not wait:
                self._queue.clear()
            self._cv.notify_all()
        if wait and self._thread is not None and self._thread.is_alive():
            self._thread.join()

    @property
    def counts(self) -> tuple[int, int, int]:
        """(submitted, completed, failed)."""
        with self._cv:
            return self._submitted, self._completed, self._failed

    def __enter__(self) -> "CompilePipeline":
        return self

    def __exit__(self, *exc) -> bool:
        self.close(wait=True)
        return False
