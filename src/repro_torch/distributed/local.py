"""Kernels on DTensors: each rank runs the plain function on its local
shards, in a layout where that is exact (the ops' own sharding
strategies), and its backward does the same.

The forward of a kernel op reaches its local shards through DTensor's
dispatch and the op's registered strategy; the backward of the port's
kernel ops recomputes through their plain versions, which make masks and
zeros of their own and so take plain tensors. :func:`local_vjp` runs
such a backward on the local shards of the saved inputs, placed in the
op's layout, and gives back DTensor gradients in the inputs' own
placements (a gradient that is a partial sum over ranks, e.g. of an
input the heads share, is reduced by that redistribution).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .actctx import global_stride

__all__ = ["local_vjp", "to_layout"]


def to_layout(x, placements):
    """``x`` redistributed to ``placements`` (None passes through)."""
    if x is None or tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def local_vjp(fn: Callable, inputs: Sequence[Optional[torch.Tensor]],
              in_layouts: Sequence, grads: Sequence[Optional[torch.Tensor]],
              out_layouts: Sequence, grad_layouts: Sequence) -> list:
    """The gradients of ``fn(*inputs)`` (a tuple of outputs) for output
    gradients ``grads``, computed per rank: every DTensor input in its
    ``in_layouts`` placements, ``fn`` on the local shards, each output
    gradient in its ``out_layouts`` placements; each input's local
    gradient is read with its ``grad_layouts`` placements and returned in
    the input's own."""
    from torch.distributed.tensor import DTensor
    placed = [to_layout(x, pl) for x, pl in zip(inputs, in_layouts)]
    locs = [None if x is None else x.to_local().detach().requires_grad_()
            for x in placed]
    with torch.enable_grad():
        outs = fn(*locs)
    pairs = [(o, to_layout(g, pl).to_local())
             for o, g, pl in zip(outs, grads, out_layouts) if g is not None]
    live = [t for t in locs if t is not None]
    got = iter(torch.autograd.grad([o for o, _ in pairs], live,
                                   [g for _, g in pairs], allow_unused=True))
    result = []
    for x, t, pl in zip(inputs, locs, grad_layouts):
        if t is None:
            result.append(None)
            continue
        g = next(got)
        if g is None:
            g = torch.zeros_like(t)
        d = DTensor.from_local(g, x.device_mesh, pl, run_check=False,
                               shape=x.shape,
                               stride=global_stride(g, x.shape))
        result.append(to_layout(d, x.placements))
    return result
