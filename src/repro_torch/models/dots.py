"""The model stack's contractions: one ``einsum`` helper for every product
the reference writes as ``jnp.einsum`` (XLA's ``dot_general``).

It does two things at each site:

- it tags the product for the remat policies
  (:mod:`repro_torch.models.remat`): while it runs, :func:`current_dot`
  gives whether the product has batch dims — a letter of both operands
  that the output keeps (``bhsk,bhtk->bhst`` has them; ``bsd,df->bsf``
  and ``bhsk,hkd->bsd`` do not) — and the product's shape.
  ``torch.einsum`` lowers both kinds to ``mm``/``bmm``, whose names
  cannot tell them apart;
- on DTensors over a mesh with more than one rank it runs
  :func:`repro_torch.distributed.einsum.sharded_einsum`, the planned
  contraction; plain tensors, and DTensors on a one-rank mesh, take
  ``torch.einsum`` itself, so a one-rank mesh computes exactly what no
  mesh does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..distributed.actctx import is_sharded
from ..distributed.einsum import expand_equation, sharded_einsum

__all__ = ["current_dot", "einsum", "has_batch_dims"]

_TAGS: list[tuple[bool, tuple[int, ...]]] = []


def has_batch_dims(eq: str, ndims: tuple[int, int]) -> bool:
    """Whether the two-operand ``eq`` keeps a letter of both operands."""
    (sa, sb), so = expand_equation(eq, ndims)
    return any(c in sb and c in so for c in sa)


def current_dot() -> Optional[tuple[bool, tuple[int, ...]]]:
    """Inside an :func:`einsum`: (whether its product has batch dims, the
    product's shape); outside one: None."""
    return _TAGS[-1] if _TAGS else None


def _out_shape(eq: str, a: torch.Tensor, b: torch.Tensor) -> tuple:
    (sa, sb), so = expand_equation(eq, (a.ndim, b.ndim))
    sizes = dict(zip(sa, a.shape))
    sizes.update(zip(sb, b.shape))
    return tuple(int(sizes[c]) for c in so)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)``, tagged, and planned over a mesh."""
    _TAGS.append((has_batch_dims(eq, (a.ndim, b.ndim)),
                  _out_shape(eq, a, b)))
    try:
        if is_sharded(a) or is_sharded(b):
            return sharded_einsum(eq, a, b)
        return torch.einsum(eq, a, b)
    finally:
        _TAGS.pop()
