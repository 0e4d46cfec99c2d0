"""Rematerialization policies (the reference's ``StepConfig.policy()``,
``getattr(jax.checkpoint_policies, name)``), on ``torch.utils.checkpoint``.

The argument-free ``jax.checkpoint_policies`` are ported:

- ``nothing_saveable``: keep only the block's inputs, recompute the rest
  (:func:`repro_torch.models.layers.checkpointed`);
- ``everything_saveable``: keep everything (the block runs as it is);
- ``dots_saveable`` (alias ``checkpoint_dots``): keep the products,
  recompute everything else;
- ``dots_with_no_batch_dims_saveable`` (alias
  ``checkpoint_dots_with_no_batch_dims``): keep the products without
  batch dims only.

A product is JAX's ``dot_general``: every contraction of the model
stack's :func:`repro_torch.models.dots.einsum`, which ``torch.einsum``
lowers to ``mm``/``bmm`` either way; the einsum sites tag whether their
product has batch dims (:func:`~repro_torch.models.dots.current_dot`), so
the policies read the tag, not the op's name. A ``mm``/``bmm`` outside a
tagged site counts as a product with batch dims when it is a ``bmm``.
The flash-attention and SSD ops are not products, as a ``pallas_call``
is not one. The selective policies run through
``torch.utils.checkpoint.create_selective_checkpoint_contexts``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from . import layers as L
from .dots import current_dot

__all__ = ["POLICIES", "check_policy", "policy_fn", "remat"]

#: the ported policies; aliases map to the policy they equal in JAX
POLICIES = {
    "nothing_saveable": "nothing_saveable",
    "everything_saveable": "everything_saveable",
    "dots_saveable": "dots_saveable",
    "checkpoint_dots": "dots_saveable",
    "dots_with_no_batch_dims_saveable": "dots_with_no_batch_dims_saveable",
    "checkpoint_dots_with_no_batch_dims": "dots_with_no_batch_dims_saveable",
}

_DOTS = frozenset({"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm"})


def check_policy(name: str) -> str:
    """The policy ``name`` stands for; any other name raises."""
    if name not in POLICIES:
        raise ValueError(f"remat policy {name!r} is not one of the "
                         f"argument-free jax.checkpoint_policies: "
                         f"{sorted(POLICIES)}")
    return POLICIES[name]


def _is_saved_dot(op, batch_ok: bool) -> bool:
    name = op._schema.name if hasattr(op, "_schema") else str(op)
    if name not in _DOTS:
        return False
    if batch_ok:
        return True
    tag = current_dot()
    has_batch = tag[0] if tag is not None else name in ("aten::bmm",
                                                        "aten::baddbmm")
    return not has_batch


def policy_fn(name: str) -> Callable:
    """``policy(ctx, op, *args, **kwargs)`` of a selective policy: save a
    product the policy keeps, recompute anything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    kind = check_policy(name)
    batch_ok = kind == "dots_saveable"
    if kind not in ("dots_saveable", "dots_with_no_batch_dims_saveable"):
        raise ValueError(f"{name!r} is not a selective policy")

    def policy(ctx, op, *args, **kwargs):
        if _is_saved_dot(op, batch_ok):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def remat(fn: Callable, name: Optional[str]) -> Callable:
    """``fn`` under policy ``name`` (None: no remat). Without grad mode
    (prefill, decode) nothing would be kept, so ``fn`` just runs."""
    if name is None:
        return fn
    kind = check_policy(name)
    if kind == "everything_saveable":
        return fn
    if kind == "nothing_saveable":
        context_fn = None
    else:
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       policy_fn(name))

    def wrapped(*args):
        if context_fn is None or not torch.is_grad_enabled():
            return L.checkpointed(fn, *args)
        return L.checkpoint(fn, *args, use_reentrant=False,
                            preserve_rng_state=False, context_fn=context_fn)

    return wrapped
