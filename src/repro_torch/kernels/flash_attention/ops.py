"""Flash attention: the hand-written CUDA forwards' wrapper, its
``torch.autograd.Function`` and its plain PyTorch version.

Three kernels replace the Pallas ``flash_attention_pallas`` /
``_attn_kernel`` of the JAX package: the online-softmax forward over
(B, H, S, D) q and (B, Hkv, S, D) k/v with f32 running (m, l, acc) state,
GQA (query head h reads kv head ``h // (H // Hkv)``), causal and
sliding-window masks, and skipping of wholly masked kv blocks. The route
is chosen by dtype and head dim, and each launch counts under its route's
key of ``flash_attention.route_launches``:

- ``"tensor_cores"``: bfloat16, on the tensor cores
  (``csrc/flash_attention_sm90.cu``: wgmma, TMA);
- ``"tf32x3"``: float32 at the head dims of :data:`TF32X3_TILES` (16, 32,
  64, 80, 128), on the TF32 tensor cores with every product split into
  three TF32 products, which keeps f32 accuracy
  (``csrc/flash_attention_tf32x3.cu``);
- ``"tf32x3_d256"``: float32 at D = 256 (:data:`TF32X3_D256_TILES`), on
  the same 3xTF32 products with Q fed to ``wgmma`` from registers, since
  Q's hi/lo copies would not fit a block's shared memory there
  (``csrc/flash_attention_tf32x3_d256.cu``).

A head dim no kernel of its dtype is compiled for raises; no route falls
back to another. The CUDA-core f32 kernel (``csrc/flash_attention.cu``),
the design the 3xTF32 kernels replaced, stays compiled to be timed beside
them and is on no route. The JAX package has no backward kernel: its
custom VJP recomputes through the dense reference, and so does
:class:`_FlashAttention` here.

``(bq, bk)`` is the tunable, as on the TPU, and keeps the TPU kernel's
meaning: the granularity at which a kv block wholly outside the causal or
window mask is skipped. Any positive pair is taken (every pair of
``model_step_space(quick=False)``, 64..512, and the block equal to S that
the padding rule gives below S = 128); a non-positive one raises. It also
selects the kernel's physical tile (:func:`physical_tile` over the route's
table in :data:`ROUTE_TILES`).

On CPU tensors :func:`flash_attention` runs the kernels' plain version
(:func:`attention_ref` on the padded operands, padded keys masked) and
counts no route; on CUDA tensors it launches a kernel or raises. Both go
through the op ``repro_torch::flash_attention_fwd``
(:mod:`repro_torch.kernels.registry`), whose fake gives the output's
shape on ``meta``.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F

from ...distributed.local import local_vjp, to_layout
from .. import build, registry

__all__ = ["OP", "ROUTE_TILES", "SM90_TILES", "TF32X3_D256_TILES",
           "TF32X3_TILES", "attention_ref", "bytes_moved", "flash_attention",
           "flops", "padded_blocks", "physical_tile", "route",
           "sm90_smem_bytes", "smem_bytes", "tf32x3_smem_bytes"]

NEG_INF = -1e30
#: the tensor-core (bf16) kernel's compiled physical tiles, (q rows, kv
#: rows) per head dim: csrc/flash_attention_sm90.cu's RT_FLASH_SM90_TILES
#: lists exactly these (D = 256 takes kv 64 only: its registers)
SM90_TILES = {**{d: ((64, 64), (64, 128), (128, 64), (128, 128))
                 for d in (16, 32, 64, 80, 128)},
              256: ((64, 64), (128, 64))}
#: the f32 tensor-core (3xTF32) kernel's compiled physical tiles, (q rows,
#: kv rows) per head dim: csrc/flash_attention_tf32x3.cu's
#: RT_FLASH_TF32X3_TILES lists exactly these (D = 128 takes kv 32 only: its
#: shared memory)
TF32X3_TILES = {**{d: ((64, 64), (128, 64)) for d in (16, 32, 64, 80)},
                128: ((64, 32), (128, 32))}
#: the f32 tensor-core kernel at head dim 256 (3xTF32, Q from registers):
#: csrc/flash_attention_tf32x3_d256.cu's RT_FLASH_TF32X3_D256_TILES lists
#: exactly these (one consumer warpgroup; the two-consumer (128, 16) tile
#: measured slower and is built by bench/flash_probe.py alone)
TF32X3_D256_TILES = {256: ((64, 32),)}
#: each route's compiled physical tiles per head dim
ROUTE_TILES = {"tensor_cores": SM90_TILES, "tf32x3": TF32X3_TILES,
               "tf32x3_d256": TF32X3_D256_TILES}
#: the physical tile's largest side
_MAX_TILE = 128
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
    """Dynamic shared memory one block of the f32 CUDA-core kernel (the
    replaced design, on no route) takes at this head dim, as the compiled
    library reports it (builds the library). Raises for a head dim the
    kernel is not compiled for: the library's tile list is the only list
    of its head dims."""
    lib = build.library()
    lib.rt_flash_attention_smem_bytes.argtypes = [ctypes.c_int]
    lib.rt_flash_attention_smem_bytes.restype = ctypes.c_int64
    n = lib.rt_flash_attention_smem_bytes(head_dim)
    if n < 0:
        raise ValueError(f"no f32 flash kernel for head dim {head_dim}")
    return n


def sm90_smem_bytes(head_dim: int, qt: int, kt: int) -> int:
    """Dynamic shared memory one block of the bf16 (tensor-core) kernel
    takes at this head dim and physical tile, as the compiled library
    reports it (builds the library); raises outside the compiled table."""
    lib = build.library()
    fn = lib.rt_flash_attention_sm90_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int64
    n = fn(head_dim, qt, kt)
    if n < 0:
        raise ValueError(f"no bf16 flash kernel for head dim {head_dim} "
                         f"tile ({qt}, {kt})")
    return n


def tf32x3_smem_bytes(head_dim: int, qt: int, kt: int) -> int:
    """Dynamic shared memory one block of the f32 tensor-core (3xTF32)
    kernel of this head dim (D = 256: the ``tf32x3_d256`` one) takes at
    this physical tile, as the compiled library reports it (builds the
    library); raises outside the compiled tables."""
    lib = build.library()
    fn = (lib.rt_flash_attention_tf32x3_d256_smem_bytes
          if head_dim in TF32X3_D256_TILES
          else lib.rt_flash_attention_tf32x3_smem_bytes)
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int64
    n = fn(head_dim, qt, kt)
    if n < 0:
        raise ValueError(f"no tf32x3 flash kernel for head dim {head_dim} "
                         f"tile ({qt}, {kt})")
    return n


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes ``dtype`` at ``head_dim``: ``"tensor_cores"``
    for bfloat16, ``"tf32x3_d256"`` for float32 at a head dim of
    :data:`TF32X3_D256_TILES`, ``"tf32x3"`` for float32 at any other (the
    launch raises where the route's table lacks the head dim)."""
    if dtype == torch.bfloat16:
        return "tensor_cores"
    if dtype == torch.float32:
        return "tf32x3_d256" if head_dim in TF32X3_D256_TILES else "tf32x3"
    raise TypeError(f"the flash kernels take float32 or bfloat16, not "
                    f"{dtype}")


def physical_tile(bq: int, bk: int,
                  tiles: Sequence[tuple[int, int]]) -> tuple[int, int]:
    """The physical (q rows, kv rows) tile that a logical (bq, bk) block
    runs on: the largest of ``tiles`` not above (min(bq, 128),
    min(bk, 128)), by area, then q rows. Where no tile is that small, each
    bound is first raised to the smallest side ``tiles`` has, so a block
    below 64 rows (the padding rule's block of a short sequence) runs on
    the smallest tile. The logical block still sets the skip
    granularity."""
    if not tiles:
        raise ValueError("no compiled flash tiles to choose from")
    cap_q = max(min(bq, _MAX_TILE), min(t[0] for t in tiles))
    cap_k = max(min(bk, _MAX_TILE), min(t[1] for t in tiles))
    fits = [t for t in tiles if t[0] <= cap_q and t[1] <= cap_k]
    if not fits:
        raise ValueError(f"no compiled flash tile fits the block ({bq}, "
                         f"{bk}): {tuple(tiles)}")
    return max(fits, key=lambda t: (t[0] * t[1], t[0]))


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


def _launcher(dtype: torch.dtype, d: int, bq: int, bk: int):
    """The ctypes launcher of the kernel that takes ``dtype`` at head dim
    ``d`` for the logical block (bq, bk), and its route (:func:`route`);
    raises for a dtype or head dim no kernel is compiled for."""
    path = route(dtype, d)
    bf16 = path == "tensor_cores"
    tiles = ROUTE_TILES[path].get(d)
    if tiles is None:
        dims = sorted(SM90_TILES if bf16 else
                      {**TF32X3_TILES, **TF32X3_D256_TILES})
        raise ValueError(f"no {'bf16' if bf16 else 'f32'} flash kernel for "
                         f"head dim {d}: compiled for {dims}")
    qt, kt = physical_tile(bq, bk, tiles)
    name = (f"rt_flash_attention_{'bf16' if bf16 else 'tf32x3'}_d{d}_q{qt}"
            f"_k{kt}")
    fn = _LAUNCHERS.get(name)
    if fn is None:
        fn = _LAUNCHERS[name] = build.kernel_fn(name, _ARGTYPES)
    return fn, path


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it that starts on a 16-byte boundary (the
    tensor-core kernel's TMA copies need one)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            sm_scale: float, causal: bool, window: Optional[int], bq: int,
            bk: int, kv_len: int) -> torch.Tensor:
    """One launch of a CUDA kernel on contiguous padded operands."""
    b, h, s, d = q.shape
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"batch {b} or heads {h} over the grid limit "
                         f"{_MAX_GRID_YZ}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash kernel takes contiguous operands")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    dev = q.device
    fn, path = _launcher(q.dtype, d, bq, bk)
    q, k, v = (_aligned(x) for x in (q, k, v))
    o = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
            k.shape[1], s, kv_len, bq, bk, int(causal), window or 0,
            sm_scale, dev.index, build.current_stream_ptr(dev.index))
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc}")
    with _COUNT_LOCK:
        flash_attention.launches += 1
        flash_attention.route_launches[path] += 1
    return o


def _padded(q, k, v, bq: int, bk: int, run) -> torch.Tensor:
    """Pad S by the JAX wrapper's rule, ``run(q, k, v, bq_, bk_, s)`` on
    the padded operands with the blocks the rule gives, slice the
    padding off."""
    s = q.shape[2]
    bq_, bk_, s_pad = padded_blocks(s, bq, bk)
    if s_pad != s:
        q, k, v = (F.pad(x, (0, 0, 0, s_pad - s)) for x in (q, k, v))
    out = run(q, k, v, bq_, bk_, s)
    return out[:, :, :s, :] if s_pad != s else out


def _kernel(q, k, v, sm_scale: float, causal: bool, window: Optional[int],
            bq: int, bk: int) -> torch.Tensor:
    """The op's CUDA implementation: the padded forward through one
    kernel launch, with the padded keys masked."""
    return _padded(q, k, v, bq, bk, lambda q, k, v, bq_, bk_, s: _launch(
        q.contiguous(), k.contiguous(), v.contiguous(), sm_scale=sm_scale,
        causal=causal, window=window, bq=bq_, bk=bk_, kv_len=s))


def _plain(q, k, v, sm_scale: float, causal: bool, window: Optional[int],
           bq: int, bk: int) -> torch.Tensor:
    """The op's CPU implementation: the kernels' plain version,
    :func:`attention_ref` on the padded operands with the padded keys
    masked."""
    return _padded(q, k, v, bq, bk, lambda q, k, v, bq_, bk_, s:
                   attention_ref(q, k, v, sm_scale=sm_scale, causal=causal,
                                 window=window, kv_len=s))


def _fake(q, k, v, sm_scale: float, causal: bool, window: Optional[int],
          bq: int, bk: int) -> torch.Tensor:
    padded_blocks(q.shape[2], bq, bk)        # the blocks' check
    return q.new_empty(q.shape)


def _op_flops(q_shape, k_shape, v_shape, sm_scale, causal, window, bq, bk,
              *, out_shape=None, **_) -> float:
    b, h, s, d = q_shape
    return flops(b, h, s, d, causal)


#: ``repro_torch::flash_attention_fwd``: a kernel forward routed by
#: :func:`route` (CUDA), the padded :func:`attention_ref` (CPU)
OP = registry.define(
    "flash_attention_fwd",
    "(Tensor q, Tensor k, Tensor v, float sm_scale, bool causal, "
    "int? window, int bq, int bk) -> Tensor",
    cpu=_plain, cuda=_kernel, fake=_fake, flops=_op_flops)


def _sharding(q, k, v, sm_scale, causal, window, bq, bk) -> list:
    """The op's DTensor strategies, per mesh dim: all replicated, all
    split on the batch, or all split on the heads — the last only where
    both the q heads and the kv heads divide by every rank count the mesh
    could split them over, so each GQA group stays whole on one rank
    (local q head i reads local kv head i // (H / Hkv), as it must)."""
    from torch.distributed.tensor import Replicate, Shard
    statics = [None] * 5
    out = [([Replicate()], [Replicate()] * 3 + statics),
           ([Shard(0)], [Shard(0)] * 3 + statics)]
    ranks = q.mesh.size()
    if q.shape[1] % ranks == 0 and k.shape[1] % ranks == 0:
        out.append(([Shard(1)], [Shard(1)] * 3 + statics))
    return out


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def _layout(q, k) -> tuple:
    """The placements q, k, v and the output take for the kernel on local
    shards: each mesh dim keeps a batch split, or a heads split where
    :func:`_sharding` allows one, and replicates anything else."""
    from torch.distributed.tensor import Replicate, Shard
    ranks = q.device_mesh.size()
    heads_ok = q.shape[1] % ranks == 0 and k.shape[1] % ranks == 0
    out = []
    for p in q.placements:
        dim = getattr(p, "dim", None)
        if isinstance(p, Shard) and (dim == 0 or (dim == 1 and heads_ok)):
            out.append(Shard(dim))
        else:
            out.append(Replicate())
    return tuple(out)


def register_sharding_strategy() -> None:
    """Register :func:`_sharding` for the op with DTensor (once)."""
    if not _SHARDING:
        from torch.distributed.tensor.experimental import register_sharding
        register_sharding(OP)(_sharding)
        _SHARDING.append(OP)


_SHARDING: list = []


def _forward(q, k, v, *, sm_scale: float, causal: bool,
             window: Optional[int], bq: int, bk: int) -> torch.Tensor:
    """The padded forward through the op: pad S by the JAX wrapper's
    rule, run a kernel (CUDA) or their plain version (CPU) with the
    padded keys masked, slice the padding off."""
    registry.check_device("flash attention", q.device)
    return OP(q, k, v, float(sm_scale), bool(causal), window, int(bq),
              int(bk))


class _FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes through
    :func:`attention_ref` (same math, so the gradients are exact for the
    function computed), as the JAX package's custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, window, bq, bk):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (sm_scale, causal, window)
        if _is_dtensor(q):
            pl = _layout(q, k)
            q, k, v = (to_layout(x, pl) for x in (q, k, v))
        return _forward(q, k, v, sm_scale=sm_scale, causal=causal,
                        window=window, bq=bq, bk=bk)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        sm_scale, causal, window = ctx.opts
        if _is_dtensor(q):
            pl = _layout(q, k)
            dq, dk, dv = local_vjp(
                lambda q, k, v: (attention_ref(q, k, v, sm_scale=sm_scale,
                                               causal=causal,
                                               window=window),),
                (q, k, v), (pl,) * 3, (g,), (pl,), (pl,) * 3)
            return dq, dk, dv, None, None, None, None, None
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
    the forward is a kernel (CUDA operands, routed by :func:`route`; each
    launch counts one in ``flash_attention.launches`` and one in its
    route's entry of ``flash_attention.route_launches``) or their plain
    version (CPU operands), inside an autograd function whose backward
    recomputes through :func:`attention_ref`. Padded keys are masked in
    every mode (the Pallas path lets them into a non-causal softmax).
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
#: launches per kernel: "tensor_cores" (bf16), "tf32x3" (f32, D <= 128) and
#: "tf32x3_d256" (f32, D = 256)
flash_attention.route_launches = {route: 0 for route in ROUTE_TILES}
flash_attention.resolve = _resolve
