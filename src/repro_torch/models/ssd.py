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
from typing import Optional

import torch
import torch.nn.functional as F

from .dots import einsum
from ..distributed.actctx import global_stride, reshape, shard_act
from ..kernels.ssd import ssd_chunk_scan
from .config import ModelConfig
from .params import ParamDef, ShapeDtype

__all__ = ["ShapeDtype", "ssd_decode", "ssd_defs", "ssd_forward",
           "ssd_reference_scan", "ssm_cache_init", "ssm_cache_logical",
           "ssm_cache_shapes"]


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
    """Depthwise causal conv, width W (small): x (B, S, C), w (W, C). A
    DTensor ``x`` is convolved on its local shard (:func:`_local_conv`)."""
    if type(x).__name__ == "DTensor":
        return _local_conv(x, w)
    W = w.shape[0]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + pad[:, i:i + x.shape[1]].float() * w[i].float()
    return out.to(x.dtype)


def _halo(tail: torch.Tensor, mesh, m: int) -> torch.Tensor:
    """The W - 1 sequence positions before each rank's block along mesh
    dim ``m``: the previous rank's last ones (``tail``), zeros on the
    first rank. Every rank gathers the tails (W - 1 positions each, an
    all-gather whose backward is a reduce-scatter, so every rank takes
    part in both directions) and keeps its predecessor's."""
    import torch.distributed._functional_collectives as funcol
    n, r = mesh.size(m), mesh.get_local_rank(m)
    tails = funcol.all_gather_tensor_autograd(tail.contiguous(), 0,
                                              (mesh, m))
    prev = tails.reshape(n, *tail.shape)[(r - 1) % n]
    return prev * (0.0 if r == 0 else 1.0)


def _local_conv(x, w):
    """The causal conv of a DTensor ``x`` on each rank's shard, ``w``
    split over the channels as ``x`` is. A sequence split over one mesh
    dim takes its halo, the W - 1 positions before each rank's block,
    from the previous rank (:func:`_halo`, the counterpart of GSPMD's
    halo exchange); one split over several is gathered. ``w``'s local gradient is a partial
    sum over the ranks that split ``x`` on other dims. Autograd runs on
    the local tensors (``to_local`` / ``from_local``), so the pad, slices
    and products need no DTensor rule (torch 2.11 has none that plans
    them on a 2-D mesh)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    seq = [m for m, p in enumerate(x.placements)
           if isinstance(p, Shard) and p.dim == 1]
    if len(seq) > 1:
        x = x.redistribute(mesh, [Replicate() if m in seq else p
                                  for m, p in enumerate(x.placements)])
        seq = []
    x_pl = list(x.placements)
    w_pl = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else Replicate()
            for p in x_pl]
    w_grad = [pw if isinstance(pw, Shard) else
              (Partial() if isinstance(px, Shard) else Replicate())
              for px, pw in zip(x_pl, w_pl)]
    if list(w.placements) != w_pl:
        w = w.redistribute(mesh, w_pl)
    xl, wl = x.to_local(), w.to_local(grad_placements=w_grad)
    W = wl.shape[0]
    if seq and mesh.size(seq[0]) > 1:
        halo = _halo(xl[:, xl.shape[1] - (W - 1):], mesh, seq[0])
    else:
        halo = xl.new_zeros((xl.shape[0], W - 1, xl.shape[2]))
    pad = torch.cat([halo, xl], dim=1)
    out = torch.zeros(xl.shape, dtype=torch.float32, device=xl.device)
    for i in range(W):
        out = out + pad[:, i:i + xl.shape[1]].float() * wl[i].float()
    out = out.to(xl.dtype)
    return DTensor.from_local(out, mesh, x_pl, run_check=False,
                              shape=x.shape, stride=global_stride(out, x.shape))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _project(p: dict, u: torch.Tensor, cfg: ModelConfig):
    """Shared front half of train/decode: projections + dt/A."""
    inner = (("batch", "act_seq", "ssm_inner") if u.ndim == 3
             else ("batch", "ssm_inner"))
    z = shard_act(einsum("...d,di->...i", u, p["in_z"]), inner)
    x = shard_act(einsum("...d,di->...i", u, p["in_x"]), inner)
    b = einsum("...d,dn->...n", u, p["in_b"])
    c = einsum("...d,dn->...n", u, p["in_c"])
    dt = einsum("...d,dh->...h", u, p["in_dt"]).float()
    dt = _softplus(dt + p["dt_bias"])
    A = -torch.exp(p["a_log"])                            # (H,), negative
    return z, x, b, c, dt, A


def _gated_out(p: dict, y: torch.Tensor, z: torch.Tensor, u_dtype,
               cfg: ModelConfig) -> torch.Tensor:
    """Gated RMSNorm (y * silu(z), normalized) and the out projection."""
    g = y * F.silu(z.float())
    var = g.square().mean(dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + cfg.norm_eps) * p["norm"].float()
    return einsum("...i,id->...d", g.to(u_dtype), p["out_proj"])


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
    # the scan splits heads, never the sequence (its state carries from
    # chunk to chunk): on a mesh, move a sequence split of x and dt onto
    # their channels and heads before the scan
    x = shard_act(x, ("batch", None, "ssm_inner"))
    dt = shard_act(dt, ("batch", None, "heads"))

    xh = reshape(x, (B, S, H, P)).float()
    out = ssd_chunk_scan(xh, dt, A, b.float(), c.float(), chunk=Q, h0=h0,
                         return_state=return_state)
    y, h_final = out if return_state else (out, None)
    y = y + p["d_skip"][:, None] * xh
    out = _gated_out(p, reshape(y, (B, S, cfg.d_inner)), z, u.dtype, cfg)
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


def ssm_cache_logical() -> dict:
    return {"ssm": ("layers", "cache_batch", "heads", None, None),
            "conv": ("layers", "cache_batch", None, "ssm_inner")}


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
    conv_out = einsum("bwc,wc->bc", window.float(), w_full.float())
    conv_out = F.silu(conv_out)
    x = conv_out[:, :cfg.d_inner]
    b = conv_out[:, cfg.d_inner:cfg.d_inner + N]
    c = conv_out[:, cfg.d_inner + N:]
    xh = x.reshape(B, H, P)
    decay = torch.exp(dt * A)                             # (B, H)
    h = cache["ssm"] * decay[..., None, None] + einsum(
        "bn,bhp->bhpn", b, xh * dt[..., None])
    y = einsum("bn,bhpn->bhp", c, h)
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
