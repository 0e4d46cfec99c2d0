"""AdamW with f32 moments, global-norm clipping, decoupled weight decay
(the JAX package's ``optim/adamw.py``).

Moment tensors reuse the parameter ParamDef tree (same shapes + logical
axes), as the reference's do.

The update has the reference's semantics, which are not
``torch.optim.AdamW``'s: the gradients are clipped by their global norm
with ``min(1, clip / (norm + 1e-9))``; the step divides by
``sqrt(v / b2c) + eps``; weight decay ``wd * p`` joins the update of
every leaf, norms and embeddings included; and ``p32 - lr * update`` is
cast back to the leaf's dtype. Each product and sum is rounded where the
reference rounds it (no fused multiply-add), so the values agree to
float32 precision.

The reference donates the parameters and the optimizer state to its
jitted step; the port updates them in place, leaf by leaf, so the
transients are a few float32 copies of one leaf, never of the tree. The
step count, the clip scale and the bias corrections stay 0-d tensors on
the device: nothing waits for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..device import resolve_device
from ..models.params import ParamDef, flatten, map_tree

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "opt_state_defs"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def opt_state_defs(defs: Any) -> dict:
    """ParamDef tree for the optimizer state (m, v in f32, + step count)."""

    def f32_def(_, d: ParamDef) -> ParamDef:
        return ParamDef(shape=d.shape, logical=d.logical, init="zeros",
                        dtype=torch.float32)

    return {
        "m": map_tree(f32_def, defs),
        "v": map_tree(f32_def, defs),
        "count": ParamDef(shape=(), logical=(), init="zeros",
                          dtype=torch.float32),
    }


def adamw_init(defs: Any, device: "str | torch.device" = "cuda") -> dict:
    """The zero optimizer state of a parameter tree on ``device``."""
    dev = resolve_device(device)
    return map_tree(lambda _, d: torch.zeros(d.shape, dtype=d.dtype,
                                             device=dev),
                    opt_state_defs(defs))


def global_norm(tree: Any) -> torch.Tensor:
    """The float32 norm of every leaf, summed in sorted-key order as the
    reference sums it."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in flatten(tree).values()))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, opt_state: dict,
                 lr: "torch.Tensor | float",
                 cfg: AdamWConfig = AdamWConfig()) -> tuple[Any, dict, dict]:
    """One AdamW step, in place on ``params`` and ``opt_state``. Returns
    (params, opt_state, metrics), the same trees, and the metrics
    ``grad_norm`` (before clipping) and ``lr`` as 0-d tensors."""
    count = opt_state["count"]
    if not isinstance(lr, torch.Tensor):
        lr = torch.full((), lr, dtype=torch.float32, device=count.device)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count.add_(1.0)
    b1c = 1.0 - torch.pow(cfg.b1, count)
    b2c = 1.0 - torch.pow(cfg.b2, count)
    g_flat, m_flat, v_flat = (flatten(t) for t in (grads, opt_state["m"],
                                                    opt_state["v"]))
    for path, p in flatten(params).items():
        g, m, v = g_flat[path], m_flat[path], v_flat[path]
        g32 = g.to(torch.float32, copy=True).mul_(scale)
        m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g32.square_().mul_(1 - cfg.b2))
        buf = g32                 # free from here: the denominator, then wd·p
        denom = torch.div(v, b2c, out=buf).sqrt_().add_(cfg.eps)
        update = torch.div(m, b1c).div_(denom)
        p32 = p if p.dtype == torch.float32 else p.to(torch.float32)
        update.add_(torch.mul(p32, cfg.weight_decay, out=buf))
        p32.sub_(update.mul_(lr))
        if p32 is not p:
            p.copy_(p32)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
