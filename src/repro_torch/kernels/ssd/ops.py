"""The SSD chunk scan: the hand-written CUDA kernel's wrapper, its
``torch.autograd.Function`` and the model-layout ``ssd_chunk_scan``.

The kernel (``csrc/ssd.cu``) replaces the Pallas ``ssd_chunk_scan_pallas``
/ ``_ssd_kernel`` of the JAX package (the contract is in
:mod:`repro_torch.kernels.ssd.ref`). It also writes, when asked, the
state after the last chunk, which the prefill cache needs, and takes an
optional initial state ``h0``. The JAX package has no backward kernel
for the scan (no custom VJP), so :class:`_ChunkScan`'s backward
recomputes through the plain version, as the flash kernel's does: the
gradients are the plain version's.

Which device takes which path: CUDA tensors launch the kernel (one count
in ``ssd_chunk_scan.launches`` per launch) or raise; CPU and ``meta``
tensors take :func:`~repro_torch.kernels.ssd.ref.ssd_chunk_scan_ref`
(``meta`` is where the work term of a model step is counted); any other
device raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Any, Optional, Sequence

import torch

from .. import build
from .ref import ssd_chunk_scan_ref

__all__ = ["MAX_STATE", "bytes_moved", "chunk_scan", "needed_flops",
           "smem_bytes", "ssd_chunk_scan"]

#: the largest state width N the kernel takes (its registers and shared
#: memory are sized for it); any P >= 1 and Q >= 1 are taken
MAX_STATE = 256
_PLAIN_DEVICES = ("cpu", "meta")
_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int64,) * 6
             + (ctypes.c_int, ctypes.c_void_p))
_MAX_GRID_YZ = 65535
_COUNT_LOCK = threading.Lock()
_LAUNCHER: list = []          # the ctypes launcher, filled at first launch


def smem_bytes(n_state: int) -> int:
    """Dynamic shared memory one block of the kernel takes at state width
    ``n_state``, as the compiled library reports it (builds the
    library); raises for a width the kernel does not take."""
    lib = build.library()
    lib.rt_ssd_chunk_scan_smem_bytes.argtypes = [ctypes.c_int64]
    lib.rt_ssd_chunk_scan_smem_bytes.restype = ctypes.c_int64
    n = lib.rt_ssd_chunk_scan_smem_bytes(n_state)
    if n < 0:
        raise ValueError(f"no SSD kernel for state width {n_state}")
    return n


def bytes_moved(B: int, H: int, S: int, Q: int, P: int, N: int,
                return_state: bool = False) -> float:
    """Bytes one f32 call must move (the arguments of :func:`flops`):
    xdt, bm, cm and cum read once, y (and the final state) written once."""
    words = 2 * B * H * S * P + 2 * B * S * N + B * H * S
    if return_state:
        words += B * H * P * N
    return 4.0 * words


def needed_flops(B: int, H: int, S: int, Q: int, P: int, N: int) -> float:
    """FLOPs the function needs (the arguments of :func:`flops`), the
    work term of its bound: each chunk's C·Bᵀ once for all heads, which
    share B and C (n_groups = 1), and both quadratic terms on the causal
    triangle only (Q(Q+1)/2 entries); per head the inter-chunk term and
    the state update, 2QPN each. :func:`flops`, the JAX package's
    formula, charges C·Bᵀ per head and the full Q x Q square."""
    n_chunks = S // Q
    tri = Q * (Q + 1)                      # 2 x the causal entries
    return B * n_chunks * (tri * N + H * (tri * P + 4.0 * Q * P * N))


def _check(xdt, bm, cm, cum, h0) -> None:
    if xdt.dim() != 5:
        raise ValueError(f"xdt must be (B, H, C, Q, P), got "
                         f"{tuple(xdt.shape)}")
    b, h, c, q, p = xdt.shape
    n = bm.shape[-1]
    if bm.shape != (b, c, q, n) or cm.shape != (b, c, q, n):
        raise ValueError(f"bad B/C shapes: {tuple(bm.shape)} "
                         f"{tuple(cm.shape)} for xdt {tuple(xdt.shape)}")
    if cum.shape != (b, h, c, q):
        raise ValueError(f"bad cum shape: {tuple(cum.shape)}")
    if h0 is not None and h0.shape != (b, h, p, n):
        raise ValueError(f"bad h0 shape: {tuple(h0.shape)}, want "
                         f"{(b, h, p, n)}")
    devices = {t.device for t in (xdt, bm, cm, cum) + (
        () if h0 is None else (h0,))}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")


def _launch(xdt, bm, cm, cum, h0, return_state: bool):
    """One launch of the CUDA kernel on f32 contiguous operands."""
    b, h, c, q, p = xdt.shape
    n = bm.shape[-1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the SSD kernel takes state widths 1..{MAX_STATE}, "
                         f"not {n}")
    if q < 1 or p < 1:
        raise ValueError(f"chunk length and head dim must be positive, got "
                         f"Q={q}, P={p}")
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"batch {b} or heads {h} over the grid limit "
                         f"{_MAX_GRID_YZ}")
    dev = xdt.device
    if not _LAUNCHER:
        _LAUNCHER.append(build.kernel_fn("rt_ssd_chunk_scan_f32", _ARGTYPES))
    y = torch.empty_like(xdt)
    h_out = (torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
             if return_state else None)
    # each chunk's C B^T, shared by the heads (only tiles on or below the
    # diagonal are written and read)
    scores = torch.empty((b, c, q, q), dtype=torch.float32, device=dev)
    rc = _LAUNCHER[0](
        xdt.data_ptr(), bm.data_ptr(), cm.data_ptr(), cum.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        None if h_out is None else h_out.data_ptr(), scores.data_ptr(), b, h,
        c, q, p, n, dev.index, build.current_stream_ptr(dev.index))
    if rc != 0:
        raise RuntimeError(f"SSD chunk-scan kernel launch failed: CUDA "
                           f"error {rc}")
    with _COUNT_LOCK:
        ssd_chunk_scan.launches += 1
    return y, h_out


def _forward(xdt, bm, cm, cum, h0, return_state: bool):
    """The kernel (CUDA operands) or its plain version (CPU and meta);
    returns (y, final state or None)."""
    kind = xdt.device.type
    if kind in _PLAIN_DEVICES:
        out = ssd_chunk_scan_ref(xdt, bm, cm, cum, h0=h0,
                                 return_state=return_state)
        return out if return_state else (out, None)
    if kind != "cuda":
        raise ValueError(f"the SSD chunk scan runs on cuda, cpu or meta, "
                         f"not {xdt.device}")
    ops = [t.float().contiguous() for t in (xdt, bm, cm, cum)]
    return _launch(*ops, None if h0 is None else h0.float().contiguous(),
                   return_state)


class _ChunkScan(torch.autograd.Function):
    """The kernel forward, saving only its inputs; the backward
    recomputes through :func:`ssd_chunk_scan_ref` and differentiates it
    (the JAX package has no backward kernel either)."""

    @staticmethod
    def forward(ctx, xdt, bm, cm, cum, h0, return_state):
        ctx.save_for_backward(xdt, bm, cm, cum, h0)
        ctx.return_state = return_state
        y, h_final = _forward(xdt, bm, cm, cum, h0, return_state)
        return (y, h_final) if return_state else y

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_()
                      for t in saved]
            out = ssd_chunk_scan_ref(*leaves[:4], h0=leaves[4],
                                     return_state=ctx.return_state)
            outs = out if ctx.return_state else (out,)
            live = [t for t in leaves if t is not None]
            got = iter(torch.autograd.grad(outs, live, grads,
                                           allow_unused=True))
        dx = [None if t is None else next(got) for t in leaves]
        return (*dx, None)


def chunk_scan(xdt: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
               cum: torch.Tensor, *, h0: Optional[torch.Tensor] = None,
               return_state: bool = False):
    """The chunk scan in the kernel layout (``xdt (B, H, C, Q, P)``,
    ``bm``/``cm (B, C, Q, N)``, ``cum (B, H, C, Q)``, f32; the wrapper
    casts), through :class:`_ChunkScan`. Returns ``y (B, H, C, Q, P)``,
    or ``(y, h_final (B, H, P, N))`` with ``return_state``. ``h0`` is an
    optional initial state (zeros by default)."""
    _check(xdt, bm, cm, cum, h0)
    return _ChunkScan.apply(xdt, bm, cm, cum, h0, bool(return_state))


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   bm: torch.Tensor, cm: torch.Tensor, *, chunk: int = 256,
                   h0: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """SSD scan over model-layout inputs (the JAX package's
    ``ops.ssd_chunk_scan``).

    Args:
      x:  (B, S, H, P)  inner activations (post-conv, post-silu)
      dt: (B, S, H)     softplus'd timestep
      a:  (H,)          negative decay rates (-exp(A_log))
      bm: (B, S, N)     B projections (n_groups=1)
      cm: (B, S, N)     C projections
      chunk: chunk length Q (``min(chunk, S)`` must divide S)
    Returns (B, S, H, P) in f32, and with ``return_state`` the state after
    the last position, (B, H, P, N) f32.
    """
    b, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"chunk {q} must be positive and divide the "
                         f"sequence length {s}")
    c = s // q
    xdt = (x * dt[..., None]).reshape(b, c, q, h, p)
    xdt = xdt.movedim(3, 1)                                # (B, H, C, Q, P)
    cum = torch.cumsum((dt * a).reshape(b, c, q, h), dim=2)
    cum = cum.movedim(3, 1)                                # (B, H, C, Q)
    bm_c = bm.reshape(b, c, q, n)
    cm_c = cm.reshape(b, c, q, n)
    out = chunk_scan(xdt, bm_c, cm_c, cum, h0=h0, return_state=return_state)
    y, h_final = out if return_state else (out, None)
    y = y.movedim(1, 3).reshape(b, s, h, p)                # (B, S, H, P)
    return (y, h_final) if return_state else y


def _resolve(args: Sequence[Any], **static):
    """Executable-cache hook: the wrapper bound to its static arguments,
    building the kernel library first when the operands live on the
    card."""
    if any(str(getattr(x, "device", "")).startswith("cuda") for x in args):
        build.library()
    return functools.partial(ssd_chunk_scan, **static)


ssd_chunk_scan.launches = 0
ssd_chunk_scan.resolve = _resolve
