"""The SSD chunk scan: the hand-written CUDA kernel's wrapper, its
``torch.autograd.Function`` and the model-layout ``ssd_chunk_scan``.

The kernel (``csrc/ssd.cu``) replaces the Pallas ``ssd_chunk_scan_pallas``
/ ``_ssd_kernel`` of the JAX package (the contract is in
:mod:`repro_torch.kernels.ssd.ref`). It also writes, when asked, the
state after the last chunk, which the prefill cache needs, and takes an
optional initial state ``h0``. One launch enqueues four CUDA kernels
(:data:`KERNELS`: each chunk's scores, each chunk's own state
contribution, the sequential state carry, the output), which meet in
two scratch tensors the wrapper allocates: the scores ``(B, C, Q, Q)``
and the chunk states ``(B, H, C, P, N)``, each with its rows rounded up
to 4 floats. Three of the kernels run 3xTF32 on Hopper's ``wgmma`` fed
by TMA, whose row strides must be multiples of 16 bytes: an operand
whose rows are not (or whose data does not start on a 16-byte boundary)
goes through a rounded-up copy first (:func:`tma_rows`). The JAX
package has no backward kernel for the scan (no custom VJP), so
:class:`_ChunkScan`'s backward recomputes through the plain version, as
the flash kernel's does: the gradients are the plain version's.

Which device takes which path, through the op
``repro_torch::ssd_chunk_scan_fwd`` (:mod:`repro_torch.kernels.registry`):
CUDA tensors launch the kernel (one count in ``ssd_chunk_scan.launches``
per launch) or raise; CPU tensors take
:func:`~repro_torch.kernels.ssd.ref.ssd_chunk_scan_ref`; ``meta`` tensors
take the op's fake, which gives the output shapes, and its FLOP formula
(:func:`needed_flops`: ``meta`` is where the work term of a model step is
counted); any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Optional, Sequence

import torch

from ...distributed.actctx import cumsum, reshape
from ...distributed.local import local_vjp, to_layout
from .. import build, registry
from ..counting import count_launch
from .ref import ssd_chunk_scan_ref

__all__ = ["KERNELS", "MAX_STATE", "OP", "bytes_moved", "chunk_scan",
           "grid", "h0_aligned", "kernel_info", "needed_flops",
           "ssd_chunk_scan", "tma_rows", "work_items"]

#: the largest state width N the kernel takes; any P >= 1 and Q >= 1 are
#: taken
MAX_STATE = 256
#: the CUDA kernels one launch enqueues, in order (their names in a trace)
KERNELS = ("ssd_scores_kernel", "ssd_states_kernel", "ssd_pass_kernel",
           "ssd_output_kernel")
_TILE = 64                    # a consumer's tile in the scores, states, output
_PASS_THREADS = 256           # threads of a state-carry block
_SMS = 132                    # an H100 SXM's SMs: the persistent grids' size
_MAX_GRID_X = 2 ** 31 - 1
_MAX_GRID_Y = 65535
_MAX_COORD = 2 ** 31 - 1      # TMA's coordinates are 32-bit signed
_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int64,) * 9
             + (ctypes.c_int, ctypes.c_void_p))
_LAUNCHER: list = []          # the ctypes launcher, filled at first launch


def h0_aligned(h0: Optional[torch.Tensor]) -> bool:
    """Whether the state carry may read ``h0`` 4 elements at a time: no
    initial state, or one whose data starts on a 16-byte boundary (the
    launcher's test in ``csrc/ssd.cu``)."""
    return h0 is None or h0.data_ptr() % 16 == 0


def tma_rows(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``x`` (contiguous, rows along its last dimension) as the kernel's
    TMA loads take it, and its row stride in elements: rows a multiple of
    4 floats (16 bytes) apart from a 16-byte aligned start. A tensor that
    is not so is copied into a buffer whose rows are rounded up to 4
    floats; the kernel never reads the columns past the tensor's own."""
    cols = x.shape[-1]
    ld = -(-cols // 4) * 4
    if ld == cols and x.data_ptr() % 16 == 0:
        return x, ld
    buf = x.new_empty((*x.shape[:-1], ld))
    buf[..., :cols].copy_(x)
    return buf, ld


def work_items(B: int, H: int, C: int, Q: int, P: int, N: int) -> dict:
    """Work items of the three tensor-core kernels at (B, H, C, Q, P, N)
    (``csrc/ssd.cu``'s ``make_grid``), each split between two consumer
    warpgroups: the scores one per (b, c, 64 rows of i, pair of 64-column
    tiles of j; pairs wholly above the diagonal counted, and skipped); the
    chunk states one per (b, c, pair of heads, 64 rows of p, 64 columns of
    n); the output one per (128 rows of i, b, c, pair of heads, 64 columns
    of p)."""
    def cdiv(a, b):
        return -(-a // b)
    q_tiles, pairs = cdiv(Q, _TILE), cdiv(H, 2)
    return {"ssd_scores_kernel": B * C * q_tiles * cdiv(q_tiles, 2),
            "ssd_states_kernel": B * C * pairs * cdiv(P, _TILE)
            * cdiv(N, _TILE),
            "ssd_output_kernel": cdiv(Q, 2 * _TILE) * B * C * pairs
            * cdiv(P, _TILE)}


def grid(B: int, H: int, C: int, Q: int, P: int, N: int,
         h0_aligned: bool = True, sms: int = _SMS) -> dict:
    """Blocks each kernel of one launch runs at (B, H, C, Q, P, N), as
    ``(gridDim.x, gridDim.y)`` (``csrc/ssd.cu``'s ``make_grid``): the
    three tensor-core kernels are persistent, one block an SM at most
    (``sms``; the launcher asks the card) walking :func:`work_items`; the
    state carry one block per (b, h, 256 threads of 4 state elements, or
    of 1 where N is not a multiple of 4 or ``h0`` is not 16-byte aligned:
    pass ``h0_aligned=False`` then, as :func:`h0_aligned` decides it)."""
    per_thread = 4 if N % 4 == 0 and h0_aligned else 1
    out = {name: (min(items, sms), 1)
           for name, items in work_items(B, H, C, Q, P, N).items()}
    out["ssd_pass_kernel"] = (-(-P * N // (_PASS_THREADS * per_thread))
                              * B * H, 1)
    return {name: out[name] for name in KERNELS}


def kernel_info() -> dict:
    """Each kernel's launch shape on the current card, as the compiled
    library reports it (builds the library): threads a block, dynamic
    shared memory a block in bytes, and the blocks an SM holds (the CUDA
    runtime's occupancy)."""
    fn = build.kernel_fn("rt_ssd_kernel_info",
                         (ctypes.c_int, ctypes.POINTER(ctypes.c_int64)))
    out = {}
    for which, name in enumerate(KERNELS):
        info = (ctypes.c_int64 * 3)()
        rc = fn(which, info)
        if rc != 0:
            raise RuntimeError(f"rt_ssd_kernel_info({which}) failed: CUDA "
                               f"error {rc}")
        out[name] = {"threads": info[0], "smem_bytes": info[1],
                     "blocks_per_sm": info[2]}
    return out


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
    if b * h * c > _MAX_COORD:
        raise ValueError(f"(B, H, C) = {(b, h, c)}: B·H·C = {b * h * c} "
                         f"chunks pass the ssd_states_kernel and "
                         f"ssd_output_kernel tensor maps' 32-bit chunk "
                         f"coordinate ({_MAX_COORD})")
    for name, (gx, gy) in grid(b, h, c, q, p, n,
                               h0_aligned(h0)).items():
        if gx > _MAX_GRID_X or gy > _MAX_GRID_Y:
            raise ValueError(f"(B, H, C, Q, P, N) = {(b, h, c, q, p, n)} "
                             f"needs a grid of ({gx}, {gy}) blocks for "
                             f"{name}, over CUDA's ({_MAX_GRID_X}, "
                             f"{_MAX_GRID_Y})")
    dev = xdt.device
    if not _LAUNCHER:
        _LAUNCHER.append(build.kernel_fn("rt_ssd_chunk_scan_f32", _ARGTYPES))
    xdt, ld_p = tma_rows(xdt)
    bm, ld_n = tma_rows(bm)
    cm, _ = tma_rows(cm)
    cum, ld_q = tma_rows(cum)
    y = torch.empty((b, h, c, q, p), dtype=torch.float32, device=dev)
    h_out = (torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
             if return_state else None)
    # each chunk's C B^T, shared by the heads (only tiles on or below the
    # diagonal are written and read), and each chunk's own state
    # contribution, which the state carry overwrites with the state
    # entering the chunk; rows as the tensor maps take them
    scores = torch.empty((b, c, q, ld_q), dtype=torch.float32, device=dev)
    states = torch.empty((b, h, c, p, ld_n), dtype=torch.float32,
                         device=dev)
    rc = _LAUNCHER[0](
        xdt.data_ptr(), bm.data_ptr(), cm.data_ptr(), cum.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        None if h_out is None else h_out.data_ptr(), scores.data_ptr(),
        states.data_ptr(), b, h, c, q, p, n, ld_p, ld_n, ld_q, dev.index,
        build.current_stream_ptr(dev.index))
    if rc != 0:
        raise RuntimeError(f"SSD chunk-scan kernel launch failed: CUDA "
                           f"error {rc}")
    count_launch(ssd_chunk_scan)
    return y, h_out


def _kernel(xdt, bm, cm, cum, h0, return_state: bool):
    """The op's CUDA implementation: one launch on f32 contiguous copies
    of the operands; the final state is a 0-element tensor unless
    ``return_state``."""
    ops = [t.float().contiguous() for t in (xdt, bm, cm, cum)]
    y, h_out = _launch(*ops,
                       None if h0 is None else h0.float().contiguous(),
                       return_state)
    return y, (h_out if return_state else y.new_empty(0))


def _plain(xdt, bm, cm, cum, h0, return_state: bool):
    """The op's CPU implementation: :func:`ssd_chunk_scan_ref`."""
    out = ssd_chunk_scan_ref(xdt, bm, cm, cum, h0=h0, return_state=True)
    return out if return_state else (out[0], out[0].new_empty(0))


def _fake(xdt, bm, cm, cum, h0, return_state: bool):
    b, h, _, _, p = xdt.shape
    y = xdt.new_empty(xdt.shape, dtype=torch.float32)
    return y, y.new_empty((b, h, p, bm.shape[-1]) if return_state else 0)


def _op_flops(xdt_shape, bm_shape, cm_shape, cum_shape, h0_shape,
              return_state, *, out_shape=None, **_) -> float:
    b, h, c, q, p = xdt_shape
    return needed_flops(b, h, c * q, q, p, bm_shape[-1])


#: ``repro_torch::ssd_chunk_scan_fwd``: the kernel (CUDA),
#: :func:`ssd_chunk_scan_ref` (CPU); returns (y, final state), the state
#: a 0-element tensor unless ``return_state``
OP = registry.define(
    "ssd_chunk_scan_fwd",
    "(Tensor xdt, Tensor bm, Tensor cm, Tensor cum, Tensor? h0, "
    "bool return_state) -> (Tensor, Tensor)",
    cpu=_plain, cuda=_kernel, fake=_fake, flops=_op_flops)


def _sharding(xdt, bm, cm, cum, h0, return_state) -> list:
    """The op's DTensor strategies, per mesh dim: all replicated, all
    split on the batch, or split on the heads (``xdt``, ``cum``, ``h0``,
    ``y`` and the state; the heads share ``bm``/``cm``, replicated).
    Chunks are never split: the state carries from one to the next. An
    empty state (no ``return_state``) stays replicated."""
    from torch.distributed.tensor import Replicate, Shard
    r = Replicate()
    h0_r = None if h0 is None else r
    state = (lambda pl: pl) if return_state else (lambda pl: r)
    out = [([r, r], [r, r, r, r, h0_r, None])]
    for dim in (0, 1):
        sd = Shard(dim)
        h0_pl = None if h0 is None else sd
        if dim == 0:
            ins = [sd, sd, sd, sd, h0_pl, None]
        else:
            ins = [sd, r, r, sd, h0_pl, None]
        out.append(([sd, state(sd)], ins))
    return out


def _layouts(xdt) -> tuple[list, list, list]:
    """Placements for the kernel on local shards: (inputs xdt, bm, cm,
    cum, h0; outputs y, state; the inputs' local gradients). Each mesh
    dim keeps a batch split of ``xdt`` (every operand split on its batch)
    or a heads split (``xdt``, ``cum``, ``h0`` and the outputs; ``bm``/
    ``cm`` replicated, their local gradients partial sums over the
    heads), and replicates anything else."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    r = Replicate()
    ins, outs, dins = [[] for _ in range(5)], [[], []], [[] for _ in range(5)]
    for p in xdt.placements:
        dim = getattr(p, "dim", None) if isinstance(p, Shard) else None
        if dim == 0:
            row_in, row_out, row_d = [Shard(0)] * 5, [Shard(0)] * 2, \
                [Shard(0)] * 5
        elif dim == 1:
            s = Shard(1)
            row_in, row_out = [s, r, r, s, s], [s, s]
            row_d = [s, Partial(), Partial(), s, s]
        else:
            row_in, row_out, row_d = [r] * 5, [r] * 2, [r] * 5
        for lst, row in ((ins, row_in), (outs, row_out), (dins, row_d)):
            for i, pl in enumerate(row):
                lst[i].append(pl)
    return ([tuple(x) for x in ins], [tuple(x) for x in outs],
            [tuple(x) for x in dins])


def register_sharding_strategy() -> None:
    """Register :func:`_sharding` for the op with DTensor (once)."""
    if not _SHARDING:
        from torch.distributed.tensor.experimental import register_sharding
        register_sharding(OP)(_sharding)
        _SHARDING.append(OP)


_SHARDING: list = []


def _forward(xdt, bm, cm, cum, h0, return_state: bool):
    """The kernel (CUDA operands), its plain version (CPU) or the output
    shapes (meta), through the op; returns (y, final state or None)."""
    registry.check_device("the SSD chunk scan", xdt.device)
    y, h_final = OP(xdt, bm, cm, cum, h0, bool(return_state))
    return y, (h_final if return_state else None)


class _ChunkScan(torch.autograd.Function):
    """The kernel forward, saving only its inputs; the backward
    recomputes through :func:`ssd_chunk_scan_ref` and differentiates it
    (the JAX package has no backward kernel either)."""

    @staticmethod
    def forward(ctx, xdt, bm, cm, cum, h0, return_state):
        ctx.save_for_backward(xdt, bm, cm, cum, h0)
        ctx.return_state = return_state
        if type(xdt).__name__ == "DTensor":
            ins, _, _ = _layouts(xdt)
            xdt, bm, cm, cum, h0 = (to_layout(x, pl) for x, pl in
                                    zip((xdt, bm, cm, cum, h0), ins))
        y, h_final = _forward(xdt, bm, cm, cum, h0, return_state)
        return (y, h_final) if return_state else y

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        if type(saved[0]).__name__ == "DTensor":
            ins, outs, dins = _layouts(saved[0])
            rs = ctx.return_state

            def ref(xdt, bm, cm, cum, h0):
                out = ssd_chunk_scan_ref(xdt, bm, cm, cum, h0=h0,
                                         return_state=rs)
                return out if rs else (out,)

            dx = local_vjp(ref, saved, ins, grads, outs[:len(grads)], dins)
            return (*dx, None)
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
    xdt = reshape(x * dt[..., None], (b, c, q, h, p))
    xdt = xdt.movedim(3, 1)                                # (B, H, C, Q, P)
    cum = cumsum(reshape(dt * a, (b, c, q, h)), dim=2)
    cum = cum.movedim(3, 1)                                # (B, H, C, Q)
    bm_c = reshape(bm, (b, c, q, n))
    cm_c = reshape(cm, (b, c, q, n))
    out = chunk_scan(xdt, bm_c, cm_c, cum, h0=h0, return_state=return_state)
    y, h_final = out if return_state else (out, None)
    y = reshape(y.movedim(1, 3), (b, s, h, p))             # (B, S, H, P)
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
