"""A dense decoder with grouped-query attention (granite-3-2b), plainly.

Pre-norm blocks: RMSNorm, attention with rotary embedding (the halves
of a head rotate as pairs) and a causal mask, a residual; RMSNorm, a
gated MLP (silu or tanh-gelu gate), a residual; a final RMSNorm and the
output head tied to the embedding. Computed in float32 (or, for the
control, with every product's operands in ``precision``), layer by
layer, queries in blocks.

Weights are the tree the benchmark made: ``embed/table`` (V_pad, D),
``ln_f`` (D), and per layer, stacked on a leading axis, ``ln1``, ``ln2``
(D), ``attn/wq`` (D, H, Dh), ``attn/wk`` and ``attn/wv`` (D, Hk, Dh),
``attn/wo`` (H, Dh, D), ``mlp/w_gate`` and ``mlp/w_up`` (D, F),
``mlp/w_down`` (F, D).

Departures from granite-3.0-2b as published, which the port shares: no
embedding, residual, attention or logit multipliers (the configuration
file lists them).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .common import attend, einsum, exact_float32, layer, rmsnorm, rope

__all__ = ["forward"]


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


def mlp(p: dict, x: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    g = _act(einsum("bsd,df->bsf", x, p["w_gate"], precision), cfg["act"])
    u = einsum("bsd,df->bsf", x, p["w_up"], precision)
    return einsum("bsf,fd->bsd", g * u, p["w_down"], precision)


def attention(p: dict, x: torch.Tensor, cfg: dict, positions: torch.Tensor,
              prefix: Optional[tuple], precision: str) -> tuple:
    """Self attention of x (B, T, D) at ``positions``, after the
    ``prefix`` keys and values (B, Hk, P, Dh, already rotated, at
    positions 0..P-1) when given. Returns the output and this call's
    rotated keys and values."""
    theta = cfg.get("rope_theta", 10000.0)
    q = rope(einsum("bsd,dhk->bhsk", x, p["wq"], precision), positions,
             theta)
    k = rope(einsum("bsd,dhk->bhsk", x, p["wk"], precision), positions,
             theta)
    v = einsum("bsd,dhk->bhsk", x, p["wv"], precision)
    keys, values, k_pos = k, v, positions
    if prefix is not None:
        pk, pv = (t.float() for t in prefix)
        keys = torch.cat([pk, k], dim=2)
        values = torch.cat([pv, v], dim=2)
        k_pos = torch.cat([torch.arange(pk.shape[2], device=x.device),
                           positions])
    out = attend(q, keys, values, positions, k_pos, cfg.get("window"),
                 precision)
    return einsum("bhsk,hkd->bsd", out, p["wo"], precision), (k, v)


def forward(weights: dict, cfg: dict, tokens: torch.Tensor, *,
            start: int = 0,
            prefix: Optional[Callable[[int], tuple]] = None,
            logits_from: int = 0, precision: str = "f32") -> dict:
    """Logits of ``tokens`` (B, T) at positions start .. start + T - 1,
    over the vocabulary, for the positions from ``logits_from`` on (B,
    T - logits_from, V), and each layer's rotated keys and values of the
    T tokens. ``prefix(layer)`` gives a layer's cached keys and values
    of positions 0 .. start - 1."""
    with torch.no_grad(), exact_float32():
        eps = cfg.get("norm_eps", 1e-5)
        positions = torch.arange(start, start + tokens.shape[1],
                                 device=tokens.device)
        table = weights["embed"]["table"]
        h = table[tokens.long()].float()
        kv = []
        for i in range(cfg["n_layers"]):
            lp = layer(weights["layers"], i)
            a, kv_i = attention(lp["attn"], rmsnorm(h, lp["ln1"], eps), cfg,
                                positions, prefix(i) if prefix else None,
                                precision)
            kv.append(kv_i)
            h = h + a
            h = h + mlp(lp["mlp"], rmsnorm(h, lp["ln2"], eps), cfg,
                        precision)
        h = rmsnorm(h[:, logits_from:], weights["ln_f"], eps)
        logits = einsum("bsd,vd->bsv", h, table[:cfg["vocab_size"]],
                        precision)
    return {"logits": logits, "kv": kv}
