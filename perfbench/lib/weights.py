"""Seeded weights, made on the device in the type they are served in.

The shapes, dtypes and initializer kinds come from a definition tree
(the port's ``api.param_defs(cfg)``: each leaf has ``shape``,
``logical``, ``init``, ``scale`` and ``dtype``); the values come from one
``torch.Generator`` on the device seeded from the run's seed, one draw
a leaf (the layers of a block are stacked in one leaf), in sorted path
order. The same seed gives the same tensors, so the reference gets its
own copy by calling :func:`make` again after the program's is freed.

A weight's normals are scaled by 1/sqrt(fan-in), the size of the axes it
contracts: all but its output axes, which are the last, or ``(heads,
head_dim)`` of a Q/K/V projection. A leaf's own ``scale`` (the
embedding's 0.02, a convolution's 0.5) wins. The configuration file's
``init`` adds the published rule that keeps a random model of full
depth from amplifying rounding from layer to layer: ``residual_outputs``
(path suffixes) and ``residual_branches``, the last projection of each
residual branch scaled by 1/sqrt(branches a token passes), GPT-2's
initialization.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

from .seeds import derive

__all__ = ["fan_in", "make"]

_HEAD_AXES = ("heads", "kv_heads")


def fan_in(shape: tuple, logical: tuple) -> int:
    dims = [(s, name) for s, name in zip(shape, logical) if name != "layers"]
    if len(dims) < 2:
        return 1
    n_out = 2 if (dims[-1][1] == "head_dim" and dims[-2][1] in _HEAD_AXES
                  and len(dims) > 2) else 1
    return max(math.prod(s for s, _ in dims[:-n_out]), 1)


def _leaves(tree: Mapping, prefix: str = ""):
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], Mapping):
            yield from _leaves(tree[key], path)
        else:
            yield path, tree[key]


def make(defs: Mapping, seed: int, device,
         init: Optional[Mapping] = None) -> dict:
    """The weight tree of ``defs`` for ``seed`` on ``device``, under the
    configuration's ``init`` rules."""
    import torch
    init = init or {}
    residual = tuple(init.get("residual_outputs", ()))
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    out: dict = {}
    for path, d in _leaves(defs):
        if d.init == "zeros":
            t = torch.zeros(d.shape, dtype=d.dtype, device=device)
        elif d.init == "ones":
            t = torch.ones(d.shape, dtype=d.dtype, device=device)
        else:
            scale = d.scale if d.scale is not None else \
                fan_in(tuple(d.shape), tuple(d.logical)) ** -0.5
            if residual and path.endswith(residual):
                scale /= math.sqrt(init["residual_branches"])
            t = torch.randn(d.shape, generator=gen, dtype=d.dtype,
                            device=device).mul_(scale)
        node = out
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = t
    return out
