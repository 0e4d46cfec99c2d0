"""Activation-sharding context: logical constraints inside model code
(the JAX package's ``distributed/actctx.py``).

Models annotate key activations with *logical* axes via
:func:`shard_act`; the step builders install a resolver that maps
logical axes -> a :class:`~repro_torch.distributed.sharding.NamedSharding`
for the active (mesh, rules), and ``shard_act`` redistributes the
activation (a DTensor) to it — the reference's
``with_sharding_constraint``. Outside any context (unit tests, meshless
runs) ``shard_act`` is a no-op.

This module deliberately imports nothing from ``repro_torch.models`` so
the model zoo can depend on it without cycles.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch

__all__ = ["activation_sharding", "along", "cumsum",
           "global_stride", "is_sharded", "on_mesh_of", "reduce_partial",
           "reshape", "shard_act", "topk"]

# resolver(logical_axes, shape) -> sharding (with .mesh, .placements) or None
Resolver = Callable[[Sequence[Optional[str]], Sequence[int]], Optional[object]]

_RESOLVER: Optional[Resolver] = None


@contextlib.contextmanager
def activation_sharding(resolver: Resolver):
    """Install a resolver for the duration of a step."""
    global _RESOLVER
    prev = _RESOLVER
    _RESOLVER = resolver
    try:
        yield
    finally:
        _RESOLVER = prev


def shard_act(x: torch.Tensor,
              logical: Sequence[Optional[str]]) -> torch.Tensor:
    """Constrain one activation to its logical layout (no-op w/o context).
    Inside a context the activation must be a DTensor: a plain tensor
    there means a step dropped off the mesh, which raises."""
    if _RESOLVER is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"logical {logical} vs shape {tuple(x.shape)}")
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError(f"shard_act{tuple(logical)} inside a sharded step "
                        f"got a plain tensor of shape {tuple(x.shape)}")
    sharding = _RESOLVER(logical, x.shape)
    if sharding is None:
        return x
    target = tuple(sharding.placements)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(sharding.mesh, target)


def on_mesh_of(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, a small tensor the model makes itself (positions, masks,
    rope angles), replicated on ``like``'s mesh when ``like`` is a
    DTensor (a DTensor op takes no plain tensor beside a DTensor); ``t``
    itself otherwise. Tensors of an activation's size are made with
    ``*_like`` instead, so that they take its sharding."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _view_groups(src: Sequence[int],
                 dst: Sequence[int]) -> list[tuple[list[int], list[int]]]:
    """The dims of ``src`` and ``dst`` that a row-major reshape maps onto
    each other, as (source dims, destination dims) groups of equal
    product; trailing size-1 dims join the last group."""
    groups: list[tuple[list[int], list[int]]] = []
    i = j = 0
    while i < len(src) and j < len(dst):
        si, dj = [i], [j]
        ps, pd = src[i], dst[j]
        i, j = i + 1, j + 1
        while ps != pd:
            if ps < pd:
                si.append(i)
                ps *= src[i]
                i += 1
            else:
                dj.append(j)
                pd *= dst[j]
                j += 1
        groups.append((si, dj))
    if groups:
        groups[-1][0].extend(range(i, len(src)))
        groups[-1][1].extend(range(j, len(dst)))
    return groups


def _view_placements(x, shape: Sequence[int]) -> tuple:
    """``x``'s placements with every shard that the reshape to ``shape``
    would cut off its shard boundary replaced by ``Replicate()``: a
    reshape keeps a dim's sharding only on the first source dim of its
    group, where both that dim and the group's first destination dim
    divide by the shard count (DTensor's view rule; GSPMD would reshard
    there)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    src = tuple(x.shape)
    factor: dict[int, int] = {}
    for md, pl in enumerate(x.placements):
        if isinstance(pl, Shard):
            factor[pl.dim] = factor.get(pl.dim, 1) * mesh.size(md)
    keep: set[int] = set()
    for si, dj in _view_groups(src, tuple(shape)):
        d = si[0]
        if d in factor and src[d] % factor[d] == 0 \
                and shape[dj[0]] % factor[d] == 0:
            keep.add(d)
    return tuple(pl if not isinstance(pl, Shard) or pl.dim in keep
                 else Replicate() for pl in x.placements)


def _resharded_for_view(x, shape: Sequence[int]):
    target = _view_placements(x, shape)
    if target == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


class _Reshape(torch.autograd.Function):
    """A DTensor reshape that reshards first, in both directions."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _resharded_for_view(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _resharded_for_view(g, ctx.in_shape).reshape(ctx.in_shape), \
            None


def reshape(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x.reshape(shape)``. A DTensor is first resharded where the
    reshape would split or merge a sharded dim off its shard boundary
    (each such dim replicated), and its gradient likewise on the way
    back; a plain tensor is reshaped as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    shape = tuple(int(s) for s in shape)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _resharded_for_view(x, shape).reshape(shape)
    return _Reshape.apply(x, shape)


def is_sharded(x: torch.Tensor) -> bool:
    """Whether ``x`` is a DTensor on a mesh of more than one rank."""
    return type(x).__name__ == "DTensor" and x.device_mesh.size() > 1


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every ``Partial`` placement reduced to ``Replicate()``
    (an all-reduce), where DTensor's own choice for the next op could be
    a reduce-scatter onto another dim followed by an all-to-all of a
    larger operand; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor):
        return x
    target = tuple(Replicate() if isinstance(p, Partial) else p
                   for p in x.placements)
    if target == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def along(t: torch.Tensor, like: torch.Tensor,
          dims: "int | Sequence[int]") -> torch.Tensor:
    """A tensor ``t`` whose dim i indexes ``like``'s dim ``dims[i]`` (a
    column index, a causal mask), sharded as ``like`` shards those dims
    when ``like`` is a DTensor (each rank keeps its own rows and columns;
    nothing moves); ``t`` itself otherwise."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(like, DTensor):
        return t
    dims = [d % like.ndim for d in ((dims,) if isinstance(dims, int)
                                    else dims)]
    mesh = like.device_mesh
    rep = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    target = [Shard(dims.index(p.dim)) if isinstance(p, Shard)
              and p.dim in dims else Replicate() for p in like.placements]
    return rep.redistribute(mesh, target)


def global_stride(local: torch.Tensor,
                  shape: Sequence[int]) -> tuple[int, ...]:
    """The stride of a dense tensor of the global ``shape`` laid out in
    ``local``'s dim order (what ``DTensor.from_local`` takes beside the
    shape): dims ordered by ``local``'s strides, outermost first."""
    order = sorted(range(local.ndim), key=lambda d: (-local.stride(d), d))
    stride = [0] * local.ndim
    step = 1
    for d in reversed(order):
        stride[d] = step
        step *= int(shape[d])
    return tuple(stride)


def _local_along(fn, x: torch.Tensor, dim: int):
    """``fn`` on ``x``'s local shard, for an op along ``dim`` that no
    rank's shard crosses (``dim`` is replicated first where it is split,
    and a ``Partial`` input is reduced first, since a local op on partial
    sums is not the op on their sum): autograd runs on the local tensors
    (``to_local``/``from_local``), so neither direction needs a DTensor
    rule for the op, which torch 2.11 lacks for some (``cumsum``'s
    backward flips, ``topk``'s scatters into a plain tensor). Returns
    DTensors with ``x``'s placements, those two replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dim = dim % x.ndim
    target = tuple(Replicate() if isinstance(p, Partial)
                   or (isinstance(p, Shard) and p.dim == dim)
                   else p for p in x.placements)
    if target != tuple(x.placements):
        x = x.redistribute(x.device_mesh, target)
    outs = fn(x.to_local())
    single = isinstance(outs, torch.Tensor)
    wrapped = []
    for o in ((outs,) if single else outs):
        shape = list(x.shape)
        shape[dim] = o.shape[dim]
        wrapped.append(DTensor.from_local(
            o, x.device_mesh, target, run_check=False, shape=tuple(shape),
            stride=global_stride(o, shape)))
    return wrapped[0] if single else tuple(wrapped)


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)``; a DTensor's on its local shards."""
    if type(x).__name__ != "DTensor":
        return torch.cumsum(x, dim=dim)
    return _local_along(lambda t: torch.cumsum(t, dim=dim), x, dim)


def topk(x: torch.Tensor, k: int, dim: int = -1, sorted: bool = True):
    """``torch.topk(x, k, dim, sorted=sorted)`` as (values, indices); a
    DTensor's on its local shards."""
    if type(x).__name__ != "DTensor":
        return torch.topk(x, k, dim=dim, sorted=sorted)
    return _local_along(lambda t: tuple(torch.topk(t, k, dim=dim,
                                                   sorted=sorted)), x, dim)
