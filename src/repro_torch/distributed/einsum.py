"""A two-operand einsum over DTensors sharded on a mesh, planned the way
GSPMD partitions a ``dot_general``.

DTensor runs ``torch.einsum`` decomposed (permutes, reshapes to 3-D, a
``bmm``) and picks each part's sharding alone; the reshapes then cut
sharded dims off their shard boundaries and fail. :func:`sharded_einsum`
plans the whole contraction instead, one mesh dim at a time:

- a ``Partial`` operand is reduced first;
- where the operands shard different letters on one mesh dim, the
  cheapest of four moves by local bytes: move one operand's split onto
  the other's letter (an all-to-all; the seq-split keys of
  ``bhqd,bhkd->bhqk`` onto the heads), or gather one operand (the FSDP
  weight gather); ties go to the earlier move of that list and to the
  second operand;
- a letter sharded in one operand is sliced to match in the other (a
  local slice, nothing moves);
- the local einsum then gives the output: sharded on that mesh dim where
  its letter is kept, ``Partial`` where it is summed.

The local einsum runs between ``to_local`` and ``from_local``, so its
backward is autograd's own on the local shards; each operand's local
gradient is declared with the placements it has (``to_local``'s
``grad_placements``: a partial sum where the operand is replicated and
the other operand or the output splits a letter it lacks), and the
redistribution back to the operand's own placements reduces it (the
gradient all-reduce or reduce-scatter).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .actctx import global_stride

__all__ = ["expand_equation", "sharded_einsum"]

_FREE = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def expand_equation(eq: str, ndims: Sequence[int]) -> tuple[list[str], str]:
    """(operand subscripts, output subscripts) of ``eq`` with ``...``
    spelled out in fresh capital letters."""
    lhs, out = eq.replace(" ", "").split("->")
    ins = lhs.split(",")
    n_ell = max((nd - (len(s) - 3) if "..." in s else 0)
                for s, nd in zip(ins, ndims))
    ell = _FREE[:n_ell]

    def fill(s: str, nd: int | None = None) -> str:
        if "..." not in s:
            return s
        k = n_ell if nd is None else nd - (len(s) - 3)
        return s.replace("...", ell[n_ell - k:])

    return [fill(s, nd) for s, nd in zip(ins, ndims)], fill(out)


def _letter(placement, subs: str):
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    if isinstance(placement, _StridedShard):
        raise ValueError("sharded_einsum takes Shard, Replicate and Partial "
                         "placements, not strided shards")
    return subs[placement.dim] if isinstance(placement, Shard) else None


def _local_bytes(x) -> int:
    return x.to_local().nbytes


def _grad_placements(mine: list, other: list, out: list, my_subs: str,
                     other_subs: str, out_subs: str) -> list:
    """Placements of one operand's local gradient: its own shards; where
    it is replicated and the other operand or the output shards a letter
    it lacks, a partial sum."""
    from torch.distributed.tensor import Partial, Replicate
    res = []
    for m, pl in enumerate(mine):
        if _letter(pl, my_subs) is not None:
            res.append(pl)
            continue
        lo = _letter(other[m], other_subs)
        lout = _letter(out[m], out_subs)
        foreign = [x for x in (lo, lout) if x is not None and
                   x not in my_subs]
        res.append(Partial() if foreign else Replicate())
    return res


def sharded_einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` for DTensors ``a`` and ``b`` on one mesh
    (see the module's docstring). Every letter of an operand must appear
    in the other operand or in the output."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    (sa, sb), so = expand_equation(eq, (a.ndim, b.ndim))
    for mine, other in ((sa, sb), (sb, sa)):
        lone = [c for c in mine if c not in other and c not in so]
        if lone:
            raise ValueError(f"{eq}: letters {lone} are summed in one "
                             f"operand only")
    mesh = a.device_mesh
    sizes = {c: n for s, x in ((sa, a), (sb, b)) for c, n in zip(s, x.shape)}
    pa = [Replicate() if isinstance(p, Partial) else p for p in a.placements]
    pb = [Replicate() if isinstance(p, Partial) else p for p in b.placements]
    for m in range(mesh.ndim):
        la, lb = _letter(pa[m], sa), _letter(pb[m], sb)
        if la is not None and lb is not None and la != lb:
            n = mesh.size(m)
            size_a, size_b = _local_bytes(a), _local_bytes(b)
            # the cheapest move, ties to the earlier: move b's split onto
            # a's letter, or a's onto b's (an all-to-all each), or gather
            # b, or gather a
            moves = []
            if la in sb:
                moves.append((size_b * (n - 1) / n, "b_to_a"))
            if lb in sa:
                moves.append((size_a * (n - 1) / n, "a_to_b"))
            moves += [(size_b * (n - 1), "gather_b"),
                      (size_a * (n - 1), "gather_a")]
            move = min(moves, key=lambda c: c[0])[1]
            if move == "b_to_a":
                pb[m], lb = Shard(sb.index(la)), la
            elif move == "a_to_b":
                pa[m], la = Shard(sa.index(lb)), lb
            elif move == "gather_b":
                pb[m], lb = Replicate(), None
            else:
                pa[m], la = Replicate(), None
        if la is not None and lb is None and la in sb:
            pb[m] = Shard(sb.index(la))
        if lb is not None and la is None and lb in sa:
            pa[m] = Shard(sa.index(lb))
    if tuple(pa) != tuple(a.placements):
        a = a.redistribute(mesh, pa)
    if tuple(pb) != tuple(b.placements):
        b = b.redistribute(mesh, pb)
    out_pl = []
    for m in range(mesh.ndim):
        letter = _letter(pa[m], sa) or _letter(pb[m], sb)
        if letter is None:
            out_pl.append(Replicate())
        elif letter in so:
            out_pl.append(Shard(so.index(letter)))
        else:
            out_pl.append(Partial())
    out_shape = tuple(sizes[c] for c in so)
    if math.prod(out_shape) == 0:
        raise ValueError(f"{eq}: empty output {out_shape}")
    from torch.distributed.tensor import DTensor
    al = a.to_local(grad_placements=_grad_placements(pa, pb, out_pl, sa, sb,
                                                     so))
    bl = b.to_local(grad_placements=_grad_placements(pb, pa, out_pl, sb, sa,
                                                     so))
    ol = torch.einsum(f"{sa},{sb}->{so}", al, bl)
    return DTensor.from_local(ol, mesh, out_pl, run_check=False,
                              shape=out_shape,
                              stride=global_stride(ol, out_shape))
