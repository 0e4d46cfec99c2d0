"""Mixture-of-Experts layer (the JAX package's ``models/moe.py``):
token-choice top-k routing with a capacity limit, GShard-style, as dense
einsums over token groups.

Tokens are split into groups of ``cfg.moe_group_size``; within a group
each expert takes at most C tokens, slots going s-major then k-major (a
token's first choice before the next token's). Tokens over capacity
fall through on the residual stream. ``drop=False`` (prefill, decode)
sizes C to hold every routed token, so a token's output does not depend
on the others in its group.

Activations carry the reference's ``shard_act`` constraints (the
identity outside a sharded step). Every one-hot is a comparison with ``arange``: an index out of
range gives a row of zeros, as ``jax.nn.one_hot`` does (that is how a
dropped token's slot disappears), and nothing checks the indices on the
host, so a decode step stays capturable in a CUDA graph. The router's
product runs in float32 (TF32 off, PyTorch's default), so that the
top-k choice is the reference's.

The layer's parts run in named :class:`~repro_torch.analysis.ops.scope`
blocks (``moe.router``, ``moe.slots``, ``moe.dispatch``,
``moe.experts``, ``moe.combine``, ``moe.aux``), so that a roofline
attribution sums the forward's ops by part.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .dots import einsum
from ..analysis.ops import scope
from ..distributed.actctx import (cumsum, on_mesh_of, reshape, shard_act,
                                  topk)
from .config import ModelConfig
from .params import ParamDef

__all__ = ["apply_moe", "aux_load_balance_loss", "capacity",
           "combine_weights", "expert_ffn", "group_shape", "moe_defs",
           "route"]


def moe_defs(cfg: ModelConfig, layers: int | None = None) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()

    def w(shape, logical, **kw):
        return ParamDef(shape=lead + shape, logical=lax_ + logical,
                        dtype=cfg.tdtype, **kw)

    return {
        "router": w((D, E), ("embed_r", "experts"), scale=0.02),
        "w_gate": w((E, D, F_), ("experts", "embed", "mlp")),
        "w_up": w((E, D, F_), ("experts", "embed", "mlp")),
        "w_down": w((E, F_, D), ("experts", "mlp", "embed")),
    }


def _round8(c: int) -> int:
    return max(8, c + (-c) % 8)


def capacity(cfg: ModelConfig, group_size: int) -> int:
    """Slots per expert and group: the routed tokens' share times the
    capacity factor, truncated, at least 8 and a multiple of 8."""
    return _round8(int(group_size * cfg.top_k * cfg.capacity_factor
                       / cfg.n_experts))


def group_shape(cfg: ModelConfig, batch: int, seq: int,
                drop: bool = True) -> tuple[int, int, int]:
    """(groups G, tokens per group Sg, slots per expert C) of a (batch,
    seq) input: Sg is the group size, or the whole sequence where it
    does not divide the tokens; C is :func:`capacity`, or with
    ``drop=False`` every routed token of a group (Sg * top_k, rounded)."""
    sg = min(cfg.moe_group_size, seq)
    if (batch * seq) % sg:
        sg = seq
    c = capacity(cfg, sg) if drop else _round8(sg * cfg.top_k)
    return batch * seq // sg, sg, c


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of integer ``idx`` over ``n`` classes; an index
    outside [0, n) gives zeros."""
    cls = on_mesh_of(torch.arange(n, device=idx.device), idx)
    return (idx[..., None] == cls).float()


def route(p: dict, xg: torch.Tensor, cfg: ModelConfig
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The router's top-k over experts of each token: (values, expert
    indices), each (..., top_k), values in descending order, from the
    float32 logits ``xg @ router``."""
    with scope("moe.router"):
        logits = einsum("gsd,de->gse", xg.float(),
                              p["router"].float())
        return topk(logits, cfg.top_k, dim=-1, sorted=True)


def combine_weights(p: dict, xg: torch.Tensor, cfg: ModelConfig,
                    slots: int) -> torch.Tensor:
    """The routing of groups ``xg`` (G, Sg, D) into ``slots`` slots an
    expert: combine[g, s, e, c], the gate probability of token s at slot
    c of expert e, 0 where it was not routed or was dropped (float32,
    (G, Sg, E, C))."""
    G, Sg, _ = xg.shape
    E, K, C = cfg.n_experts, cfg.top_k, slots
    gate_vals, gate_idx = route(p, xg, cfg)                 # (G, Sg, K)
    with scope("moe.slots"):
        probs = torch.softmax(gate_vals, dim=-1)
        eoh = _one_hot(gate_idx, E)                         # (G, Sg, K, E)

        # position within expert, s-major then k-major priority
        flat = eoh.reshape(G, Sg * K, E)
        pos = (cumsum(flat, dim=1) - flat).reshape(G, Sg, K, E)
        kept = eoh * (pos < C).float()
        slot = (pos * eoh).sum(-1)                          # chosen slot id
        slot_oh = _one_hot(slot.long(), C)                  # (G, Sg, K, C)

        # the reference's three-operand einsum "gske,gskc,gsk->gsec", with
        # probs folded into kept and k contracted by one batched product.
        # A token takes each expert at most once, so each element has one
        # nonzero term and equals the reference's exactly.
        weighted = kept * probs[..., None]
        return einsum("gske,gskc->gsec", weighted, slot_oh)


def expert_ffn(p: dict, ein: torch.Tensor) -> torch.Tensor:
    """Each expert's gated FFN over its capacity-packed tokens: ein
    (G, E, C, D) -> (G, E, C, D)."""
    hidden = ("batch", None, None, "mlp")
    with scope("moe.experts"):
        h = F.silu(shard_act(einsum("gecd,edf->gecf", ein,
                                          p["w_gate"]), hidden))
        h = h * shard_act(einsum("gecd,edf->gecf", ein, p["w_up"]),
                          hidden)
        return shard_act(einsum("gecf,efd->gecd", h, p["w_down"]),
                         ("batch", None, None, "act_embed"))


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              drop: bool = True) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); one layer's experts ``p``."""
    B, S, D = x.shape
    G, Sg, C = group_shape(cfg, B, S, drop)
    xg = reshape(x, (G, Sg, D))
    combine = combine_weights(p, xg, cfg, C)                # (G, Sg, E, C)
    with scope("moe.dispatch"):
        dispatch = (combine > 0.0).to(x.dtype)
        ein = shard_act(einsum("gsec,gsd->gecd", dispatch, xg),
                        ("batch", None, None, "act_embed"))  # (G, E, C, D)
    del dispatch
    out_e = expert_ffn(p, ein)
    del ein
    with scope("moe.combine"):                              # un-dispatch
        y = einsum("gecd,gsec->gsd", out_e, combine.to(out_e.dtype))
    return shard_act(reshape(y, (B, S, D)),
                     ("batch", "act_seq", "act_embed"))


def aux_load_balance_loss(p: dict, x: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (fraction of routed
    choices times mean router probability, per expert)."""
    with scope("moe.aux"):
        logits = einsum("bsd,de->bse", x.float(), p["router"].float())
        probs = torch.softmax(logits, dim=-1)               # (B, S, E)
        _, idx = topk(logits, cfg.top_k, dim=-1)
        frac = _one_hot(idx, cfg.n_experts).mean(dim=(0, 1, 2))
        mean_prob = probs.mean(dim=(0, 1))
        return cfg.n_experts * torch.sum(frac * mean_prob)
