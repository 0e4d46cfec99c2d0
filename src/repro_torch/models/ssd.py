"""Mamba2 SSD (state-space duality) layer (the JAX package's
``models/ssd.py``).

Follows Dao & Gu (arXiv:2405.21060): within a chunk the recurrence is a
masked attention-like quadratic form; across chunks a (B, H, P, N) state
is carried. Where the reference does the chunk scan in plain ``jnp``
inside ``lax.scan``, :func:`ssd_forward` runs it through the port's SSD
kernel (:func:`repro_torch.kernels.ssd.ssd_chunk_scan`: the CUDA kernel
on the card, its plain version on the host), the same function the
reference's Pallas kernel computes. The kernel's autograd function keeps
only its inputs for the backward pass, the memory behaviour of the
reference's ``jax.checkpoint``-ed chunk body.

Projections are split per component (z/x/B/C/dt), as in the reference.
Decode carries (ssm_state (B, H, P, N) f32, conv_state (B, W-1, dim)).
``softplus`` is ``logaddexp(x, 0)``, which is ``jax.nn.softplus``;
``torch.nn.functional.softplus`` would switch to x above 20.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.ssd import ssd_chunk_scan
from .config import ModelConfig
from .params import ParamDef

__all__ = ["ShapeDtype", "ssd_decode", "ssd_defs", "ssd_forward",
           "ssd_reference_scan", "ssm_cache_init", "ssm_cache_shapes"]


class ShapeDtype(NamedTuple):
    """Shape and dtype of one cache tensor (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: torch.Size
    dtype: torch.dtype


def ssd_defs(cfg: ModelConfig, layers: int | None = None) -> dict:
    D, Din, N, H, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.conv_width)
    lead = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()

    def w(shape, logical, **kw):
        return ParamDef(shape=lead + shape, logical=lax_ + logical,
                        dtype=cfg.tdtype, **kw)

    def small(shape, **kw):
        return ParamDef(shape=lead + shape,
                        logical=lax_ + (None,) * len(shape),
                        dtype=torch.float32, **kw)

    return {
        "in_z": w((D, Din), ("embed", "ssm_inner")),
        "in_x": w((D, Din), ("embed", "ssm_inner")),
        "in_b": w((D, N), ("embed", "ssm_state")),
        "in_c": w((D, N), ("embed", "ssm_state")),
        "in_dt": w((D, H), ("embed", "heads")),
        "conv_x": w((W, Din), ("conv", "ssm_inner"), scale=0.5),
        "conv_b": w((W, N), ("conv", "ssm_state"), scale=0.5),
        "conv_c": w((W, N), ("conv", "ssm_state"), scale=0.5),
        "dt_bias": small((H,), init="zeros"),
        "a_log": small((H,), init="ones"),
        "d_skip": small((H,), init="ones"),
        "norm": w((Din,), (None,), init="ones"),
        "out_proj": w((Din, D), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width W (small): x (B, S, C), w (W, C)."""
    W = w.shape[0]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + pad[:, i:i + x.shape[1]].float() * w[i].float()
    return out.to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _project(p: dict, u: torch.Tensor, cfg: ModelConfig):
    """Shared front half of train/decode: projections + dt/A."""
    z = torch.einsum("...d,di->...i", u, p["in_z"])
    x = torch.einsum("...d,di->...i", u, p["in_x"])
    b = torch.einsum("...d,dn->...n", u, p["in_b"])
    c = torch.einsum("...d,dn->...n", u, p["in_c"])
    dt = torch.einsum("...d,dh->...h", u, p["in_dt"]).float()
    dt = _softplus(dt + p["dt_bias"])
    A = -torch.exp(p["a_log"])                            # (H,), negative
    return z, x, b, c, dt, A


def _gated_out(p: dict, y: torch.Tensor, z: torch.Tensor, u_dtype,
               cfg: ModelConfig) -> torch.Tensor:
    """Gated RMSNorm (y * silu(z), normalized) and the out projection."""
    g = y * F.silu(z.float())
    var = g.square().mean(dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + cfg.norm_eps) * p["norm"].float()
    return torch.einsum("...i,id->...d", g.to(u_dtype), p["out_proj"])


def ssd_forward(p: dict, u: torch.Tensor, cfg: ModelConfig,
                h0: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Full-sequence SSD. u: (B, S, D) -> (B, S, D).

    ``return_state=True`` additionally returns the decode cache
    {ssm (B,H,P,N) f32, conv (B,W-1,Din+2N)} after the last position
    (prefill path); the kernel writes the ssm state."""
    B, S, D = u.shape
    H, P, N, Q = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  min(cfg.ssm_chunk, S))
    if S % Q:
        Q = math.gcd(S, Q)  # odd test lengths: largest common chunk
    z, x, b, c, dt, A = _project(p, u, cfg)
    if return_state:
        W = cfg.conv_width
        conv_tail = torch.cat([x, b, c], dim=-1)[:, S - (W - 1):, :]
    x = F.silu(_causal_conv(x, p["conv_x"]))
    b = F.silu(_causal_conv(b, p["conv_b"]))
    c = F.silu(_causal_conv(c, p["conv_c"]))

    xh = x.reshape(B, S, H, P).float()
    out = ssd_chunk_scan(xh, dt, A, b.float(), c.float(), chunk=Q, h0=h0,
                         return_state=return_state)
    y, h_final = out if return_state else (out, None)
    y = y + p["d_skip"][:, None] * xh
    out = _gated_out(p, y.reshape(B, S, cfg.d_inner), z, u.dtype, cfg)
    if return_state:
        return out, {"ssm": h_final, "conv": conv_tail.to(cfg.tdtype)}
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def ssm_cache_shapes(cfg: ModelConfig, layers: int, batch: int) -> dict:
    H, P, N, W = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.conv_width)
    dim = cfg.d_inner + 2 * N
    return {
        "ssm": ShapeDtype(torch.Size((layers, batch, H, P, N)),
                          torch.float32),
        "conv": ShapeDtype(torch.Size((layers, batch, W - 1, dim)),
                           cfg.tdtype),
    }


def ssm_cache_init(cfg: ModelConfig, layers: int, batch: int,
                   device: "str | torch.device" = "cpu") -> dict:
    shapes = ssm_cache_shapes(cfg, layers, batch)
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in shapes.items()}


def ssd_decode(p: dict, u: torch.Tensor, cache: dict,
               cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode. u: (B, 1, D); cache: {ssm (B,H,P,N) f32,
    conv (B,W-1,Din+2N)}. Returns (y (B,1,D), new_cache)."""
    B = u.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, x, b, c, dt, A = _project(p, u[:, 0], cfg)        # (B, ·)
    # conv over the rolling window of raw (pre-activation) projections
    xbc = torch.cat([x, b, c], dim=-1)
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)
    w_full = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window.float(), w_full.float())
    conv_out = F.silu(conv_out)
    x = conv_out[:, :cfg.d_inner]
    b = conv_out[:, cfg.d_inner:cfg.d_inner + N]
    c = conv_out[:, cfg.d_inner + N:]
    xh = x.reshape(B, H, P)
    decay = torch.exp(dt * A)                             # (B, H)
    h = cache["ssm"] * decay[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", b, xh * dt[..., None])
    y = torch.einsum("bn,bhpn->bhp", c, h)
    y = y + p["d_skip"][:, None] * xh
    out = _gated_out(p, y.reshape(B, cfg.d_inner), z, u.dtype, cfg)
    new_cache = {"ssm": h, "conv": window[:, 1:].to(cache["conv"].dtype)}
    return out[:, None, :], new_cache


def ssd_reference_scan(p: dict, u: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """Step-by-step recurrence oracle (O(S) sequential) used by tests to
    validate the chunked path."""
    B, S, D = u.shape
    cache = {k: v[0] for k, v in ssm_cache_init(cfg, 1, B,
                                                u.device).items()}
    ys = []
    for t in range(S):
        y, cache = ssd_decode(p, u[:, t:t + 1], cache, cfg)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1)
