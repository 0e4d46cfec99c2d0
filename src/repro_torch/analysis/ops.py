"""Per-op FLOPs and bytes of one eager call, from torch's dispatcher.

The JAX package reads per-op cost out of the compiled HLO text
(``parse_hlo_ops``/``parse_hlo_cost``); an eager PyTorch program has no
module text, so :func:`count_ops` watches one call of the function
instead, through a ``TorchDispatchMode``:

- every op that reaches the dispatcher below autograd is one record
  (composite ops arrive decomposed, as ``torch.profiler`` nests them),
  except views and other aliasing ops, which move no data; a record is
  named ``<op>#<k>`` (``aten::mm#3``, ``repro_torch::triad#0``), k being
  its occurrence among the call's ops of that name, and ``kind`` is the
  op's name;
- FLOPs come from ``torch.utils.flop_counter``'s formula registry, which
  covers the matrix products and, through
  :mod:`repro_torch.kernels.registry`, the port's four hand kernels;
- bytes are the ``nbytes`` of the tensors the op reads plus those it
  writes, the counterpart of XLA's "bytes accessed" (the destination of
  ``copy_``, ``fill_`` and the like is written, not read; allocations
  move nothing);
- an op without a formula that moves bytes is a memory op; an op that
  does neither keeps a zero-cost record (``modeled=False``, so measured
  device time can still join it) and is tallied in ``unhandled``;
- an op dispatched inside a :class:`scope` block carries the innermost
  block's name (``scope``), so a report can sum a module's parts (the
  MoE layer's router, dispatch, experts and combine). Autograd's
  backward runs after the forward's blocks have closed: its ops carry
  none.

It runs on ``meta`` tensors as well as real ones: the counterpart of
tracing with ``jax.ShapeDtypeStruct``, with nothing allocated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch
from torch.profiler import record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["ModuleOps", "OpCost", "OpCounter", "count_ops", "op_key",
           "scope"]

#: ops that only allocate: they read and write nothing
_ALLOCATING = frozenset({
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::new_empty", "aten::new_empty_strided", "aten::resize_",
})
#: in-place ops whose first argument is written, not read
_WRITE_ONLY_SELF = frozenset({
    "aten::copy_", "aten::fill_", "aten::zero_", "aten::normal_",
    "aten::uniform_", "aten::random_", "aten::bernoulli_",
    "aten::exponential_",
})


@dataclasses.dataclass(frozen=True)
class OpCost:
    """One op of the call with its cost.

    ``kind`` is the op's name (``aten::mm``); ``modeled`` is False for an
    op that neither has a FLOP formula nor moves bytes — the record
    still exists (so measured device time can be joined against it) but
    carries zero cost.
    """

    name: str                    # "<op>#<k>"
    kind: str
    flops: float
    bytes_accessed: float
    modeled: bool = True
    scope: str = ""              # the innermost open :class:`scope`

    @property
    def intensity(self) -> float:
        """Arithmetic intensity I = FLOPs / bytes of this op (paper
        Eq. 1). Zero-traffic compute is ``inf``; zero-work movement 0."""
        if self.bytes_accessed <= 0:
            return float("inf") if self.flops > 0 else 0.0
        return self.flops / self.bytes_accessed


@dataclasses.dataclass(frozen=True)
class ModuleOps:
    """Per-op cost records of one call."""

    ops: tuple[OpCost, ...]
    unhandled: dict[str, int]    # op kinds seen but not cost-modeled

    @property
    def flops(self) -> float:
        return sum(o.flops for o in self.ops)

    @property
    def bytes_accessed(self) -> float:
        return sum(o.bytes_accessed for o in self.ops)

    def by_name(self) -> dict[str, OpCost]:
        return {o.name: o for o in self.ops}


#: the names of the open :class:`scope` blocks, innermost last
_SCOPES: list[str] = []


class scope:
    """``with scope("moe.experts"):`` names the part of a model that the
    ops dispatched inside belong to, for an op count. Outside a count it
    only pushes and pops the name (nothing reaches the device, so a CUDA
    graph captures through it)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        _SCOPES.append(self.name)

    def __exit__(self, *exc) -> None:
        _SCOPES.pop()


def op_key(name: str, occurrence: int) -> str:
    """The record name of the ``occurrence``-th op called ``name``."""
    return f"{name}#{occurrence}"


#: ops that reinterpret their input's storage without moving it, though
#: their schemas do not say so
_METADATA = frozenset({"aten::_unsafe_view", "aten::lift_fresh"})


def _aliases(func: torch._ops.OpOverload) -> bool:
    """Views, and ops whose every result aliases an input unwritten."""
    if func.is_view or func._schema.name in _METADATA:
        return True
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


def _nbytes(tree) -> float:
    leaves, _ = tree_flatten(tree)
    return float(sum(t.nbytes for t in leaves if isinstance(t, torch.Tensor)))


class OpCounter(TorchDispatchMode):
    """The dispatch mode behind :func:`count_ops`: one record per
    non-aliasing op, in call order. ``n_dispatched`` counts every op
    dispatched, views included (0 = the call did no tensor work).

    With ``mark=True`` each recorded op runs inside a
    ``torch.profiler.record_function`` range named by its key, so a
    profiler window over the same call can charge every kernel to the
    op that launched it (:mod:`repro_torch.obs.device_timing`)."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # torch's opt-out of wrapping ``__torch_dispatch__`` in dynamo's
        # ``disable``: the counter never runs under ``torch.compile``, and
        # the wrapper's first call imports ``torch._dynamo``, which costs
        # seconds in every process that runs the tuner's pre-run audit
        return False

    def __init__(self, mark: bool = False):
        super().__init__()
        self.mark = mark
        self.records: list[OpCost] = []
        self.unhandled: dict[str, int] = {}
        self.n_dispatched = 0
        self._seen: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.n_dispatched += 1
        if _aliases(func):
            return func(*args, **kwargs)
        name = func._schema.name
        k = self._seen.get(name, 0)
        self._seen[name] = k + 1
        if self.mark:
            with record_function(op_key(name, k)):
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        flops = float(formula(*args, **kwargs, out_val=out)) if formula \
            else 0.0
        if name in _ALLOCATING:
            moved = 0.0
        else:
            read = (args[1:], kwargs) if name in _WRITE_ONLY_SELF \
                else (args, kwargs)
            moved = _nbytes(read) + _nbytes(out)
        modeled = flops > 0 or moved > 0
        if not modeled:
            self.unhandled[name] = self.unhandled.get(name, 0) + 1
        self.records.append(OpCost(name=op_key(name, k), kind=name,
                                   flops=flops, bytes_accessed=moved,
                                   modeled=modeled,
                                   scope=_SCOPES[-1] if _SCOPES else ""))
        return out

    def module(self) -> ModuleOps:
        return ModuleOps(ops=tuple(self.records),
                         unhandled=dict(self.unhandled))


def count_ops(fn: Callable, args: Sequence[Any] = (),
              kwargs: Optional[dict] = None) -> ModuleOps:
    """Per-op cost records of one call ``fn(*args, **kwargs)`` (eager; on
    ``meta`` arguments nothing is allocated or run)."""
    with OpCounter() as counter:
        fn(*args, **(kwargs or {}))
    return counter.module()
