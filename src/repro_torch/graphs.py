"""Captured steps: the port's counterpart of ``jax.jit``.

The reference compiles a step once (``jax.jit``) and runs the executable
after that. On the card the port records a step's kernels once in a CUDA
graph and replays the graph, so that a step stops being the host issuing
its ops one by one. :func:`captured` wraps a step function:

* **One graph per call signature**: the shapes, dtypes and devices (and a
  DTensor's placements) of the tensor leaves, the identity of the donated
  leaves, and every other argument that is not a device scalar. The first
  call at a signature runs eagerly (the warm-up: its result is real, and
  whatever a capture cannot do, such as building the kernel library or
  creating a communicator, happens there); the second captures the step
  and replays it; later calls replay.
* **Device scalars**: a Python int in a ``device_scalars`` position (a
  train step's ``step_idx``, decode's ``pos``) is filled into a static 0-d
  int64 tensor before each call, so the graph reads it from the card and
  does not hold the value it was captured with (a tensor there is an
  input like any other).
* **Donated arguments** (``donate_argnums``: parameters and optimizer
  state, a decode cache) are the graph's buffers themselves: the step
  updates them in place. A donated leaf that the step returns as a new
  tensor (a decode's new SSM states) is copied back into it inside the
  capture, and the step's result holds the donated leaf in its place. The
  returned tree of a donated argument is found by its structure: the
  element of the result with the same paths, shapes and dtypes.
* **Other tensor inputs** are copied into static buffers before each
  replay. A leaf passed as the same tensor at the warm-up and at the
  capture (the weights of a decode loop, a tuner's fixed batch) is read in
  place instead, as long as later calls pass it again; a call that passes
  another tensor there starts the signature again.
* **Outputs** that are not donated are the graph's own buffers: the next
  call overwrites them. A caller that keeps one clones it.
* **Launch counts**: a kernel launched while capturing runs nothing, so
  it is recorded and not counted (:mod:`repro_torch.kernels.counting`),
  and the record is added at every replay:
  :func:`repro_torch.kernels.launch_counts` counts kernel executions.

Captures run under one lock with ``capture_error_mode="thread_local"``,
so a tuner's ``thread:N`` workers may capture and replay steps side by
side. A capture that fails raises; nothing falls back to the eager step.
:meth:`Captured.release` frees the graphs and their memory pools.

On tensors that are not on a card, the same staging runs with the
recorded step called directly on the static buffers in place of a
replay, its outputs copied into the first call's; the capture call runs
under a guard that refuses what a capture cannot record (a host read of
a device value, an output whose shape depends on values). Callers take
this helper only where :func:`enabled` says so: on ``cuda``, outside
:func:`disabled`. On ``cpu`` and ``meta`` every step stays eager.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .kernels import counting

__all__ = ["Captured", "HostSyncError", "captured", "disabled", "enabled"]

_CAPTURE_LOCK = threading.Lock()
_STATE_LOCK = threading.Lock()
_STATE = {"disabled": 0}


def enabled(device: "str | torch.device") -> bool:
    """Whether a step on ``device`` runs through :func:`captured`: on
    ``cuda``, outside :func:`disabled`."""
    return torch.device(device).type == "cuda" and not _STATE["disabled"]


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Every step runs eagerly inside the block (the counterpart of
    ``jax.disable_jit``), for every thread of the process."""
    with _STATE_LOCK:
        _STATE["disabled"] += 1
    try:
        yield
    finally:
        with _STATE_LOCK:
            _STATE["disabled"] -= 1


class HostSyncError(RuntimeError):
    """A staged step did what a CUDA graph cannot record."""


class _NoHostSync(TorchDispatchMode):
    """Refuses the ops that read a device value on the host or give an
    output whose shape depends on values: a capture refuses them too."""

    REFUSED = ("_local_scalar_dense", "nonzero", "masked_select",
               "_unique2", "unique_consecutive", "unique_dim")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.REFUSED:
            raise HostSyncError(
                f"aten.{name} reads the device on the host or gives a "
                f"value-dependent shape: a captured step cannot hold it")
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# trees: nested dicts, lists and tuples
# ---------------------------------------------------------------------------


def _leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree: Any, leaf: Callable[[tuple, Any], Any],
             path: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaf, path + (i,))
                          for i, v in enumerate(tree))
    return leaf(path, tree)


def _structure(tree: Any) -> tuple:
    """Paths, shapes and dtypes of a tree's tensor leaves (None for a tree
    with another leaf)."""
    out = []
    for path, x in _leaves(tree):
        if not isinstance(x, torch.Tensor):
            return None
        out.append((path, tuple(x.shape), x.dtype))
    return tuple(out)


class _Entry:
    """One signature: its warm-up leaves, then its graph."""

    def __init__(self, warm: dict, scalars: dict):
        self.warm = warm        # path -> the warm-up's non-donated tensor
        self.scalars = scalars  # path -> static 0-d tensor
        self.copied: list = []  # (path, static buffer) filled per call
        self.held: list = []    # (path, tensor) read in place
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replay: Optional[Callable[[], None]] = None
        self.out: Any = None
        self.launches: list = []

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.replay = self.out = None
        self.copied, self.held, self.warm = [], [], {}


class Captured:
    """A step function run as a captured graph (see the module)."""

    def __init__(self, fn: Callable, donate_argnums: tuple = (),
                 device_scalars: tuple = ()):
        self.fn = fn
        self.donate_argnums = tuple(donate_argnums)
        self.device_scalars = tuple(device_scalars)
        self._entries: dict = {}

    # -- signature ---------------------------------------------------------

    def _kind(self, path: tuple, x: Any) -> str:
        if not isinstance(x, torch.Tensor):
            return "scalar" if path[0] in self.device_scalars else "static"
        return "donated" if path[0] in self.donate_argnums else "input"

    def _key(self, leaves: list) -> tuple:
        """The call's signature (its non-tensor arguments must hash)."""
        key = []
        for path, x in leaves:
            kind = self._kind(path, x)
            if kind == "scalar":
                key.append((path, kind))
            elif kind == "static":
                key.append((path, kind, x))
            else:
                key.append((path, kind, tuple(x.shape), x.dtype, x.device,
                            tuple(getattr(x, "placements", ())),
                            id(x) if kind == "donated" else None))
        return tuple(key)

    # -- the calls ---------------------------------------------------------

    def __call__(self, *args):
        leaves = list(_leaves(args))
        key = self._key(leaves)
        entry = self._entries.get(key)
        if entry is None:
            return self._warm_up(key, args, leaves)
        if entry.replay is None:
            return self._capture(entry, args, leaves)
        by_path = dict(leaves)
        if any(by_path[path] is not x for path, x in entry.held):
            # a leaf read in place was swapped: this call is a new warm-up
            entry.release()
            del self._entries[key]
            return self._warm_up(key, args, leaves)
        for path, static in entry.copied:
            src = by_path[path]
            if src is not static:
                static.copy_(src)
        self._fill_scalars(entry, by_path)
        entry.replay()
        counting.add(entry.launches)
        return entry.out

    def _warm_up(self, key: tuple, args: tuple, leaves: list):
        device = next((x.device for _, x in leaves
                       if isinstance(x, torch.Tensor)), torch.device("cpu"))
        scalars = {path: torch.zeros((), dtype=torch.int64, device=device)
                   for path, x in leaves if self._kind(path, x) == "scalar"}
        warm = {path: x for path, x in leaves
                if self._kind(path, x) == "input"}
        entry = _Entry(warm, scalars)
        self._fill_scalars(entry, dict(leaves))
        static = self._args(args, entry, lambda path, x: x)
        out = self._written_back(self.fn(*static), static)
        self._entries[key] = entry
        return out

    def _capture(self, entry: _Entry, args: tuple, leaves: list):
        for path, x in leaves:
            if self._kind(path, x) != "input":
                continue
            if entry.warm.get(path) is x:
                entry.held.append((path, x))
            else:
                entry.copied.append((path, x.clone()))
        entry.warm = {}
        self._fill_scalars(entry, dict(leaves))
        buffers = dict(entry.copied)
        static = self._args(args, entry,
                            lambda path, x: buffers.get(path, x))
        on_card = any(x.device.type == "cuda" for _, x in leaves
                      if isinstance(x, torch.Tensor))
        try:
            (self._record if on_card else self._stage)(entry, static)
        except BaseException:
            entry.release()
            self._entries = {k: e for k, e in self._entries.items()
                             if e is not entry}
            raise
        return entry.out

    def _record(self, entry: _Entry, static: tuple) -> None:
        """Capture the step on the static buffers, then replay it once:
        the capture itself runs nothing."""
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, counting.recording() as seen:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self._written_back(self.fn(*static), static)
        entry.graph, entry.out, entry.launches = graph, out, list(seen)
        entry.replay = graph.replay
        graph.replay()
        counting.add(entry.launches)

    def _stage(self, entry: _Entry, static: tuple) -> None:
        """The host's stand-in for :meth:`_record`: the step runs on the
        static buffers under the host-sync guard (this call's result),
        and each replay runs it again and copies its outputs into these."""
        with _NoHostSync():
            out = self._written_back(self.fn(*static), static)

        def replay() -> None:
            new = dict(_leaves(self._written_back(self.fn(*static),
                                                  static)))
            for path, kept in _leaves(out):
                if isinstance(kept, torch.Tensor) and new[path] is not kept:
                    kept.copy_(new[path])

        entry.out, entry.replay = out, replay

    # -- helpers -----------------------------------------------------------

    def _args(self, args: tuple, entry: _Entry,
              buffer: Callable[[tuple, Any], Any]) -> tuple:
        return _rebuild(args, lambda path, x: entry.scalars.get(
            path, buffer(path, x) if isinstance(x, torch.Tensor) else x))

    @staticmethod
    def _fill_scalars(entry: _Entry, by_path: dict) -> None:
        for path, static in entry.scalars.items():
            static.fill_(int(by_path[path]))

    def _written_back(self, out: Any, static: tuple) -> Any:
        """``out`` with the tree of each donated argument it returns
        holding the donated leaves, each leaf returned as a new tensor
        first copied into its donated one."""
        if not self.donate_argnums:
            return out
        parts = list(out) if isinstance(out, (tuple, list)) else [out]
        shapes = [_structure(p) for p in parts]
        for i in self.donate_argnums:
            want = _structure(static[i])
            for j, got in enumerate(shapes):
                if got is None or got != want:
                    continue
                donated = dict(_leaves(static[i]))

                def back(path, x, donated=donated):
                    d = donated[path]
                    if x is not d:
                        d.copy_(x)
                    return d

                parts[j] = _rebuild(parts[j], back)
                shapes[j] = None            # one donated tree per part
                break
        if isinstance(out, (tuple, list)):
            return type(out)(parts)
        return parts[0]

    def release(self) -> None:
        """Free every graph and its memory pool; the next call at any
        signature is a warm-up again."""
        for entry in self._entries.values():
            entry.release()
        self._entries = {}


def captured(fn: Callable, donate_argnums: tuple = (),
             device_scalars: tuple = ()) -> Captured:
    """``fn`` run as a captured graph from its second call at a signature
    on (see the module)."""
    return Captured(fn, donate_argnums, device_scalars)
