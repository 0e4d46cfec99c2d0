"""Flash attention: the hand-written CUDA forward's wrapper, its
``torch.autograd.Function`` and its plain PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas
``flash_attention_pallas`` / ``_attn_kernel`` of the JAX package: the
online-softmax forward over (B, H, S, D) q and (B, Hkv, S, D) k/v with
f32 running (m, l, acc) state, GQA (query head h reads kv head
``h // (H // Hkv)``), causal and sliding-window masks, and skipping of
wholly masked kv blocks. The JAX package has no backward kernel: its
custom VJP recomputes through the dense reference, and so does
:class:`_FlashAttention` here.

``(bq, bk)`` is the tunable, as on the TPU. On the card the kernel's
physical tiles are fixed per head dim by its register and shared-memory
budget; a logical (bq, bk) block is processed in those sub-tiles and
keeps the TPU kernel's meaning: the granularity at which a kv block
wholly outside the causal or window mask is skipped. Any positive pair
is taken (every pair of ``model_step_space(quick=False)``, 64..512, and
the block equal to S that the padding rule gives below S = 128); a
non-positive one raises.

On CPU tensors :func:`flash_attention` runs the kernel's plain version
(:func:`attention_ref` on the padded operands, padded keys masked); on
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F

from .. import build

__all__ = ["attention_ref", "bytes_moved", "flash_attention", "flops",
           "padded_blocks", "smem_bytes"]

NEG_INF = -1e30
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 7
             + (ctypes.c_int, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p))
_MAX_GRID_YZ = 65535
_COUNT_LOCK = threading.Lock()
#: (dtype, head dim) -> ctypes launcher, filled at its first launch
_LAUNCHERS: dict = {}


def flops(b: int, h: int, s: int, d: int, causal: bool) -> float:
    """Attention FLOPs: 2 matmuls of (s, d)x(d, s) and (s, s)x(s, d),
    halved under a causal mask (the JAX package's formula)."""
    full = 2.0 * b * h * (2.0 * s * s * d)
    return full / 2.0 if causal else full


def bytes_moved(q: torch.Tensor, k: torch.Tensor) -> float:
    """Bytes one call must move: q, k and v read once, the output
    written once."""
    return float((2 * q.numel() + 2 * k.numel()) * q.element_size())


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory one block of the kernel takes at this head
    dim, as the compiled library reports it (builds the library). Raises
    for a head dim the kernel is not compiled for: the library's tile
    list is the only list of head dims."""
    lib = build.library()
    lib.rt_flash_attention_smem_bytes.argtypes = [ctypes.c_int]
    lib.rt_flash_attention_smem_bytes.restype = ctypes.c_int64
    n = lib.rt_flash_attention_smem_bytes(head_dim)
    if n < 0:
        raise ValueError(f"no flash kernel for head dim {head_dim}")
    return n


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: Optional[float] = None, causal: bool = True,
                  window: Optional[int] = None,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """Dense attention over (B, H, S, D) q and (B, Hkv, S, D) k/v: GQA by
    repeating kv heads, causal and window masks at -1e30, f32 math,
    output in q's dtype. ``kv_len`` also masks keys at or past it (the
    padded keys of the kernel's plain version)."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kb = k.repeat_interleave(group, dim=1)
    vb = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kb.float()) * sm_scale
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    if kv_len is not None:
        mask &= k_pos < kv_len
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vb.float())
    return out.to(q.dtype)


def padded_blocks(s: int, bq: int, bk: int) -> tuple[int, int, int]:
    """The padding rule of the JAX wrapper: blocks ``min(b, s)`` from
    S = 128 up, the whole sequence below it; S is padded to a multiple
    of the larger block. Returns (bq_, bk_, padded S)."""
    if bq < 1 or bk < 1:
        raise ValueError(f"flash attention blocks must be positive, got "
                         f"({bq}, {bk})")
    bq_ = min(bq, s) if s >= 128 else s
    bk_ = min(bk, s) if s >= 128 else s
    return bq_, bk_, s + (-s) % max(bq_, bk_)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention wants (B, H, S, D) q and equal "
                         f"(B, Hkv, S, D) k/v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d):
        raise ValueError(f"shape mismatch q={tuple(q.shape)} "
                         f"k={tuple(k.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"q heads {h} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            sm_scale: float, causal: bool, window: Optional[int], bq: int,
            bk: int, kv_len: int) -> torch.Tensor:
    """One launch of the CUDA kernel on contiguous padded operands."""
    b, h, s, d = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, not "
                        f"{q.dtype}")
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"batch {b} or heads {h} over the grid limit "
                         f"{_MAX_GRID_YZ}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash kernel takes contiguous operands")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    dev = q.device
    key = (q.dtype, d)
    fn = _LAUNCHERS.get(key)
    if fn is None:
        smem_bytes(d)                      # raises for an uncompiled dim
        fn = _LAUNCHERS[key] = build.kernel_fn(
            f"rt_flash_attention_{_DTYPES[q.dtype]}_d{d}", _ARGTYPES)
    o = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
            k.shape[1], s, kv_len, bq, bk, int(causal), window or 0,
            sm_scale, dev.index, build.current_stream_ptr(dev.index))
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc}")
    with _COUNT_LOCK:
        flash_attention.launches += 1
    return o


def _forward(q, k, v, *, sm_scale: float, causal: bool,
             window: Optional[int], bq: int, bk: int) -> torch.Tensor:
    """The padded forward: pad S by the JAX wrapper's rule, run the
    kernel (CUDA) or its plain version (CPU) with the padded keys
    masked, slice the padding off."""
    s = q.shape[2]
    bq_, bk_, s_pad = padded_blocks(s, bq, bk)
    if s_pad != s:
        q, k, v = (F.pad(x, (0, 0, 0, s_pad - s)) for x in (q, k, v))
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, sm_scale=sm_scale, causal=causal,
                            window=window, kv_len=s)
    elif q.device.type == "cuda":
        out = _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                      sm_scale=sm_scale, causal=causal, window=window,
                      bq=bq_, bk=bk_, kv_len=s)
    else:
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")
    return out[:, :, :s, :] if s_pad != s else out


class _FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes through
    :func:`attention_ref` (same math, so the gradients are exact for the
    function computed), as the JAX package's custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, window, bq, bk):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (sm_scale, causal, window)
        return _forward(q, k, v, sm_scale=sm_scale, causal=causal,
                        window=window, bq=bq, bk=bk)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        sm_scale, causal, window = ctx.opts
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_ref(*leaves, sm_scale=sm_scale, causal=causal,
                                window=window)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: Optional[float] = None, causal: bool = True,
                    window: Optional[int] = None, bq: int = 512,
                    bk: int = 512, use_kernel: bool = True) -> torch.Tensor:
    """Attention over (B, H, S, D); pads S to the block size.

    ``use_kernel=False`` is the dense :func:`attention_ref`. Otherwise
    the forward is the kernel (CUDA operands; each launch counts one in
    ``flash_attention.launches``) or its plain version (CPU operands),
    inside an autograd function whose backward recomputes through
    :func:`attention_ref`. Padded keys are masked in every mode (the
    Pallas path lets them into a non-causal softmax).
    """
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not use_kernel:
        return attention_ref(q, k, v, sm_scale=sm_scale, causal=causal,
                             window=window)
    return _FlashAttention.apply(q, k, v, float(sm_scale), bool(causal),
                                 window, int(bq), int(bk))


def _resolve(args: Sequence[Any], bq: int = 512, bk: int = 512, **static):
    """Executable-cache hook: the wrapper bound to this (bq, bk) (checked
    by the padding rule), building the kernel library first when the
    operands live on the card."""
    padded_blocks(128, bq, bk)
    if any(str(getattr(x, "device", "")).startswith("cuda") for x in args):
        build.library()
    return functools.partial(flash_attention, bq=bq, bk=bk, **static)


flash_attention.launches = 0
flash_attention.resolve = _resolve
