"""Per-device cost of one step over DTensors: the port's counterpart of
the JAX package's ``lower().compile()`` + ``cost_analysis`` /
``memory_analysis`` / ``parse_collectives``.

:class:`DeviceCounter` watches one eager call (on ``meta`` tensors over
a fake world, nothing is allocated or sent) and keeps, for this rank:

- FLOPs and bytes of every local op, by :mod:`repro_torch.analysis.ops`'
  rules (DTensor's ops arrive on the local shards);
- the collectives that DTensor's redistributions plan, as the
  ``_c10d_functional`` ops it calls, before any backend sees them (a
  fake or CPU backend may carry out an all-to-all as an all-gather,
  which would change what is counted): :class:`CollectiveStats`, with
  the reference's names, group sizes from the process group, and the
  reference's traffic formulas;
- memory: the local bytes of the arguments and of the outputs (storages
  the call made; an argument updated in place, the port's donation,
  adds none), and the peak of the bytes live in storages the call made.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable, Sequence

import torch
from torch.utils._pytree import tree_flatten

from .ops import OpCost, OpCounter, op_key

__all__ = ["COLLECTIVES", "CollectiveStats", "DeviceCounter", "StepTrace",
           "collective_traffic", "trace_call"]

#: ``_c10d_functional`` op -> the reference's (HLO) collective name
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclasses.dataclass
class CollectiveStats:
    """Per-device collective traffic estimate (the reference's
    ``analysis.hlo.CollectiveStats``)."""

    bytes_by_op: dict[str, float]
    count_by_op: dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def summary(self) -> str:
        parts = [f"{op}:{cnt}x/{by/1e6:.1f}MB"
                 for op, (cnt, by) in sorted(
                     {o: (self.count_by_op[o], self.bytes_by_op[o])
                      for o in self.count_by_op}.items())]
        return " ".join(parts) if parts else "none"


def collective_traffic(op: str, size: float, n: int) -> float:
    """Bytes one device moves for collective ``op`` over a group of ``n``
    whose result is ``size`` bytes on it (the reference's formulas)."""
    frac = (n - 1) / n
    if op == "all-reduce":
        return 2.0 * size * frac
    if op == "all-gather":
        return size * frac
    if op == "reduce-scatter":
        return size * (n - 1)
    if op == "all-to-all":
        return size * frac
    return float(size)                      # collective-permute


def _group_size(args: Sequence[Any], kwargs: dict) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in (*args, *kwargs.values()) if isinstance(a, str)]
    if not names:
        raise ValueError("a collective without a group name")
    return _resolve_process_group(names[-1]).size()


@dataclasses.dataclass(frozen=True)
class StepTrace:
    """What one traced call costs this rank."""

    flops: float
    bytes_accessed: float
    collectives: CollectiveStats
    args_bytes: float
    out_bytes: float
    temp_bytes: float
    n_ops: int

    @property
    def peak_bytes(self) -> float:
        """args + outputs + temporaries (the reference's sum of
        ``memory_analysis``'s three sizes)."""
        return self.args_bytes + self.out_bytes + self.temp_bytes


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _storages(tree) -> dict[int, tuple[torch.UntypedStorage, int]]:
    leaves, _ = tree_flatten(tree)
    out = {}
    for t in leaves:
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            out[id(st)] = (st, st.nbytes())
    return out


class DeviceCounter(OpCounter):
    """:class:`OpCounter` that also tallies collectives and the bytes live
    in storages made during the call (see the module's docstring)."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self._paused = 0
        self._patched: list = []
        self._args = _storages(args)
        self._made: dict[int, int] = {}
        self._live = 0
        self.peak_live = 0
        self.coll_bytes: dict[str, float] = defaultdict(float)
        self.coll_count: dict[str, int] = defaultdict(int)

    def _free(self, key: int) -> None:
        self._live -= self._made.pop(key, 0)

    def _track(self, out) -> None:
        for key, (st, nbytes) in _storages(out).items():
            if key in self._args or key in self._made:
                continue
            self._made[key] = nbytes
            self._live += nbytes
            weakref.finalize(st, self._free, key)
        self.peak_live = max(self.peak_live, self._live)

    def __enter__(self):
        # DTensor's shard-to-shard move is one all-to-all, which on a CPU
        # mesh it carries out as an all-gather and a chunk: count the
        # all-to-all it plans, not the fallback's ops
        from torch.distributed.tensor import placement_types
        orig = placement_types.shard_dim_alltoall

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            self._paused += 1
            try:
                out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._paused -= 1
            self._collective("all-to-all", out, mesh.size(mesh_dim))
            self.records.append(OpCost(
                name=op_key("all_to_all", self.coll_count["all-to-all"]),
                kind="all_to_all", flops=0.0,
                bytes_accessed=float(input.nbytes + out.nbytes)))
            self._track(out)
            return out

        placement_types.shard_dim_alltoall = alltoall
        self._patched.append((placement_types, orig))
        return super().__enter__()

    def __exit__(self, *exc):
        for module, orig in self._patched:
            module.shard_dim_alltoall = orig
        self._patched.clear()
        return super().__exit__(*exc)

    def _collective(self, op: str, out, n: int) -> None:
        if n > 1:
            size = sum(t.nbytes for t in tree_flatten(out)[0]
                       if isinstance(t, torch.Tensor))
            self.coll_bytes[op] += collective_traffic(op, size, n)
            self.coll_count[op] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._paused and not any(t.__name__ == "DTensor"
                                    for t in types):
            return func(*args, **(kwargs or {}))
        n_before = len(self.records)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or len(self.records) == n_before:
            return out
        self._track(out)
        ns, _, name = func._schema.name.partition("::")
        if ns == "_c10d_functional" and name in COLLECTIVES:
            self._collective(COLLECTIVES[name], out,
                             _group_size(args, kwargs or {}))
        return out

    def trace(self, outputs: Any) -> StepTrace:
        made_out = {k: b for k, (_, b) in _storages(outputs).items()
                    if k not in self._args}
        out_bytes = float(sum(made_out.values()))
        return StepTrace(
            flops=self.module().flops,
            bytes_accessed=self.module().bytes_accessed,
            collectives=CollectiveStats(bytes_by_op=dict(self.coll_bytes),
                                        count_by_op=dict(self.coll_count)),
            args_bytes=float(sum(b for _, b in self._args.values())),
            out_bytes=out_bytes,
            temp_bytes=max(float(self.peak_live) - out_bytes, 0.0),
            n_ops=len(self.records))


def trace_call(fn: Callable, args: Sequence[Any] = ()) -> StepTrace:
    """The per-device :class:`StepTrace` of one call ``fn(*args)``."""
    with DeviceCounter(args) as counter:
        out = fn(*args)
    return counter.trace(out)
