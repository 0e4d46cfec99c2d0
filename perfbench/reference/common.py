"""What every reference shares: the precision of its products, the norms,
rotary embedding and activations, and attention in blocks of queries."""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch

__all__ = ["PRECISIONS", "attend", "cast", "einsum", "exact_float32",
           "layer", "rmsnorm", "rope"]

#: ``f32``: the reference; ``fp8``: each product's operands rounded to
#: float8 e4m3 with one scale a tensor (the control of a bfloat16
#: model); ``tf32``: operands rounded to TF32's 10-bit mantissa, products
#: accumulated in float32 (the control of a float32 product)
PRECISIONS = ("f32", "fp8", "tf32")

_FP8_MAX = 448.0        # the largest finite float8 e4m3 value
_Q_BLOCK = 512          # queries per block of attention scores


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """float32 products in float32, not TF32, inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) on TF32's 10 explicit
    mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def cast(x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """A product's operand in ``precision``, held in float32."""
    if precision == "f32":
        return x.float()
    if precision == "fp8":
        return _round_fp8(x)
    if precision == "tf32":
        return _round_tf32(x)
    raise ValueError(f"unknown precision {precision!r}")


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    return torch.einsum(eq, cast(a, precision), cast(b, precision))


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a tree of weights stacked on a leading axis."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, H, S, Dh) at positions (S,): the first
    and second halves of the head rotate as pairs."""
    dh = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    angles = positions.float()[:, None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor,
           window: Optional[int], precision: str = "f32") -> torch.Tensor:
    """Causal softmax attention of q (B, H, Sq, Dh) over k, v (B, Hk, Sk,
    Dh), query head h reading key head h // (H / Hk); a key is seen when
    its position is at most the query's and, with a window, less than
    ``window`` behind it. Scores in blocks of queries, so the (Sq, Sk)
    square never lives whole."""
    b, h, sq, dh = q.shape
    hk = k.shape[1]
    group = h // hk
    out = []
    for lo in range(0, sq, _Q_BLOCK):
        qb = q[:, :, lo:lo + _Q_BLOCK]
        n = qb.shape[2]
        qg = qb.reshape(b, hk, group * n, dh)
        s = einsum("bgqd,bgkd->bgqk", qg, k, precision) / math.sqrt(dh)
        s = s.reshape(b, hk, group, n, -1)
        qp = q_pos[lo:lo + n][:, None]
        seen = k_pos[None, :] <= qp
        if window is not None:
            seen &= (qp - k_pos[None, :]) < window
        s = torch.where(seen, s, float("-inf"))
        p = torch.softmax(s, dim=-1).reshape(b, hk, group * n, -1)
        o = einsum("bgqk,bgkd->bgqd", p, v, precision)
        out.append(o.reshape(b, h, n, dh))
    return torch.cat(out, dim=2)
