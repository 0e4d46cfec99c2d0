"""Logical-axis sharding rules -> per-tensor specs and DTensor placements,
divisibility-aware (the JAX package's ``distributed/sharding.py``).

Models annotate every parameter and activation dim with a *logical* axis
name ("embed", "heads", "mlp", "vocab", ...). A :class:`ShardingRules`
maps each logical name to mesh axis names. :func:`logical_to_spec`
resolves the mapping against a concrete mesh, *dropping* any mesh axis
that does not evenly divide the dimension (fallback = replication on that
axis) — this is what lets one rule set serve all ten architectures.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated),
one mesh-axis name, or a tuple of them (the dim split over several axes,
major to minor in the spec's order) — the entries of the reference's
``PartitionSpec``. :func:`placements` turns a spec into DTensor
placements on a :class:`~torch.distributed.device_mesh.DeviceMesh`. DTensor
splits a dim over several mesh dims in mesh order; where a spec lists
them in another order, the placements use ``_StridedShard`` so that the
local shard at every mesh coordinate is the reference's slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

from ..models.params import ParamDef, map_tree

__all__ = ["SERVE_RULES", "TRAIN_RULES", "NamedSharding", "ShardingRules",
           "activation_spec", "logical_to_spec", "mesh_axes", "placements",
           "sharding_tree", "spec_tree"]

MeshAxes = tuple[str, ...]
#: one entry per tensor dim: None, a mesh-axis name, or a tuple of them
Spec = tuple


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis names (in priority order)."""

    rules: Mapping[str, MeshAxes]
    name: str = "custom"

    def get(self, logical: str | None) -> MeshAxes:
        if logical is None:
            return ()
        return self.rules.get(logical, ())

    def replace(self, **updates: MeshAxes) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(updates)
        return ShardingRules(rules=merged, name=self.name + "+")


# Default rule sets. "pod" is pure data parallelism across pods; "data"
# carries DP + FSDP (ZeRO-3 weight sharding on the contraction dim);
# "model" carries TP (heads / mlp / vocab) and the decode-cache sequence
# split.
TRAIN_RULES = ShardingRules(name="train", rules={
    # activations: batch over DP axes; the sequence dim of saved block
    # boundaries is sharded over "model" (Megatron-style sequence
    # parallelism)
    "batch": ("pod", "data"),
    "act_seq": ("model",),
    "act_embed": (),
    # weights
    "embed": ("data",),          # FSDP: contraction dim sharded over data
    "embed_r": (),               # replicated d_model (embedding table)
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": (),
    "head_dim": (),
    "mlp": ("model",),
    "experts": (),               # expert dim replicated; expert mlp TP'd
    "layers": (),
    "frames": (),
    "ssm_inner": ("model",),
    "ssm_state": (),
    "conv": (),
    # decode cache (unused in train)
    "cache_seq": ("model",),
    "cache_batch": ("data",),
})

SERVE_RULES = ShardingRules(name="serve", rules={
    "batch": ("data",),
    "act_seq": (),
    "act_embed": (),
    "embed": ("data",),          # 2D weight sharding for big checkpoints
    "embed_r": (),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": (),
    "head_dim": (),
    "mlp": ("model",),
    "experts": (),
    "layers": (),
    "frames": (),
    "ssm_inner": ("model",),
    "ssm_state": (),
    "conv": (),
    "cache_seq": ("model",),
    "cache_batch": ("data",),
})


def mesh_axes(mesh: Any) -> dict[str, int]:
    """Mesh axis name -> size: a ``DeviceMesh``'s named dims, or the
    mapping a JAX-style mesh keeps in ``shape``."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def logical_to_spec(logical: Sequence[str | None], shape: Sequence[int],
                    rules: ShardingRules, mesh: Any) -> Spec:
    """Resolve one tensor's logical axes to a spec.

    Mesh axes that are absent from the mesh or do not divide the dim size
    are dropped (replication fallback). A mesh axis may be consumed by
    only one dim (first wins), as in the reference.
    """
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    entries: list[Any] = []
    for dim_size, name in zip(shape, logical):
        axes: list[str] = []
        divisor = 1
        for ax in rules.get(name):
            if ax in used or ax not in sizes:
                continue
            nxt = divisor * sizes[ax]
            if dim_size % nxt == 0:
                axes.append(ax)
                used.add(ax)
                divisor = nxt
        if not axes:
            entries.append(None)
        elif len(axes) == 1:
            entries.append(axes[0])
        else:
            entries.append(tuple(axes))
    return tuple(entries)


def placements(spec: Spec, mesh: Any) -> tuple:
    """DTensor placements (one per mesh dim) of a spec: ``Shard(d)`` on
    each mesh dim the spec puts on tensor dim d, ``Replicate()`` on the
    others. A dim split over several mesh axes is split major to minor in
    the spec's order: a mesh dim that the spec lists after an axis it
    precedes on the mesh gets ``_StridedShard`` with the product of those
    axes' sizes as its split factor. A mesh dim of one rank splits
    nothing: it is ``Replicate()`` whatever the spec says (the same local
    tensor, and DTensor's view rules then never refuse to reshape a dim
    that a one-rank axis "shards")."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    register_kernel_strategies()
    names = list(mesh.mesh_dim_names)
    sizes = mesh_axes(mesh)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for i, ax in enumerate(axes):
            if sizes[ax] == 1:
                continue
            later_on_mesh = [a for a in axes[:i]
                             if names.index(a) > names.index(ax)]
            factor = 1
            for a in later_on_mesh:
                factor *= sizes[a]
            out[names.index(ax)] = (Shard(dim) if factor == 1 else
                                    _StridedShard(dim, split_factor=factor))
    return tuple(out)


def register_kernel_strategies() -> None:
    """Register the DTensor sharding strategies of the port's kernel ops
    (flash attention, the SSD chunk scan), once, before a DTensor reaches
    them; kept out of import time, which DTensor's import would slow by
    about a second."""
    from ..kernels.flash_attention import ops as flash_ops
    from ..kernels.ssd import ops as ssd_ops
    flash_ops.register_sharding_strategy()
    ssd_ops.register_sharding_strategy()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def distribute(self, t: torch.Tensor):
        """``t`` (the whole tensor, on every rank) as a DTensor with this
        sharding: each rank keeps its own slice of its copy, so placing
        moves nothing between ranks (``src_data_rank=None``)."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, self.placements,
                                 src_data_rank=None)


def spec_tree(defs: Any, rules: ShardingRules, mesh: Any) -> Any:
    """Spec tree for a ParamDef tree."""
    return map_tree(lambda _, d: _def_spec(d, rules, mesh), defs)


def sharding_tree(defs: Any, rules: ShardingRules, mesh: Any) -> Any:
    """NamedSharding tree for a ParamDef tree."""
    return map_tree(lambda _, d: NamedSharding(
        mesh, _def_spec(d, rules, mesh)), defs)


def _def_spec(d: ParamDef, rules: ShardingRules, mesh: Any) -> Spec:
    if not isinstance(d, ParamDef):
        raise TypeError(f"unexpected leaf {type(d)}")
    return logical_to_spec(d.logical, d.shape, rules, mesh)


def activation_spec(rules: ShardingRules, mesh: Any,
                    logical: Sequence[str | None],
                    shape: Sequence[int]) -> Spec:
    """Spec for an activation/input tensor (same resolution path)."""
    return logical_to_spec(logical, shape, rules, mesh)
