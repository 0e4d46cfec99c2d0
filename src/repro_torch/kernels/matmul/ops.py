"""Blocked GEMM, C = A @ B: the hand-written CUDA kernel's wrapper, its
tile table and its plain PyTorch version.

The kernel (``csrc/matmul.cu``) replaces the Pallas ``matmul_pallas`` of
the JAX package: a CUDA-core design (f32 stays full f32) with a two-stage
shared-memory ring fed by ``cp.async`` and 8 x 8 (16 x 8 on the
128 x 128 tiles up to bk = 16) register tiles per thread. Its (bm, bn, bk) tile is the autotuner's tunable, as
the VMEM tile is on the TPU; the tiles are compiled ahead as a fixed
table (:data:`TILES`) and a tile outside it raises. Ragged edges are
masked inside the kernel, so no operand is padded on the host. On a CPU
tensor :func:`matmul` runs :func:`matmul_ref`; on a CUDA tensor it
launches the kernel or raises. Both go through the op
``repro_torch::matmul`` (:mod:`repro_torch.kernels.registry`).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Any, Sequence

import torch

from .. import build, registry

__all__ = ["OP", "TILES", "flops", "matmul", "matmul_ref", "smem_bytes"]

#: the compiled (bm, bn, bk) tile table — csrc/matmul.cu instantiates
#: exactly these, for float32 and bfloat16
TILES = tuple((bm, bn, bk) for bm in (64, 128) for bn in (64, 128)
              for bk in (8, 16, 32))

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_void_p)
_MAX_GRID_Y = 65535
_COUNT_LOCK = threading.Lock()
#: (dtype, tile) -> ctypes launcher, filled at its first launch
_LAUNCHERS: dict = {}


def smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory one block takes on float32 operands (the
    tile search's dtype; bf16 takes half): a ring of two stages, each the
    (bk, bm) slice of A transposed with rows padded by 4 elements and the
    (bk, bn) slice of B. The search-space constraint holds it to the
    device's per-block limit (the counterpart of the TPU's ``vmem_bytes``
    budget)."""
    return 2 * (bk * (bm + 4) + bk * bn) * 4


def flops(m: int, n: int, k: int) -> float:
    """FLOPs of one C = A@B evaluation (the paper's DGEMM FLOP count)."""
    return 2.0 * m * n * k


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: f32 product cast to the input dtype, matching
    the kernel's dtype policy."""
    return (a.float() @ b.float()).to(a.dtype)


def _check_tile(bm: int, bn: int, bk: int) -> None:
    if (bm, bn, bk) not in TILES:
        raise ValueError(f"tile ({bm}, {bn}, {bk}) is not in the compiled "
                         f"table {TILES}")


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul wants (m, k) @ (k, n), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"matmul takes float32 or bfloat16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, "
                         f"{b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul operands must be contiguous (row-major)")


def _launch(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
            bk: int) -> torch.Tensor:
    """The op's CUDA implementation: one launch of the kernel on the
    current stream (no synchronisation), counted in ``matmul.launches``."""
    dev = a.device
    m, k = a.shape
    n = b.shape[1]
    if -(-m // bm) > _MAX_GRID_Y:
        raise ValueError(f"m={m} needs more than {_MAX_GRID_Y} row blocks "
                         f"of {bm}")
    key = (a.dtype, bm, bn, bk)
    fn = _LAUNCHERS.get(key)
    if fn is None:
        fn = _LAUNCHERS[key] = build.kernel_fn(
            f"rt_matmul_{_DTYPES[a.dtype]}_{bm}x{bn}x{bk}", _ARGTYPES)
    c = torch.empty((m, n), dtype=a.dtype, device=dev)
    rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, dev.index,
            build.current_stream_ptr(dev.index))
    if rc != 0:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        matmul.launches += 1
    return c


def _plain(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
           bk: int) -> torch.Tensor:
    return matmul_ref(a, b)


def _fake(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
          bk: int) -> torch.Tensor:
    return a.new_empty((a.shape[0], b.shape[1]))


def _op_flops(a_shape, b_shape, bm, bn, bk, *, out_shape=None,
              **_) -> float:
    return flops(a_shape[0], b_shape[1], a_shape[1])


#: ``repro_torch::matmul``: the kernel at one tile (CUDA),
#: :func:`matmul_ref` (CPU)
OP = registry.define(
    "matmul", "(Tensor a, Tensor b, int bm, int bn, int bk) -> Tensor",
    cpu=_plain, cuda=_launch, fake=_fake, flops=_op_flops)


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
           bn: int = 128, bk: int = 16) -> torch.Tensor:
    """C = A @ B with a (bm, bn, bk) tile from :data:`TILES`, through the
    op ``repro_torch::matmul``.

    CPU operands take :func:`matmul_ref`; CUDA operands launch the
    kernel on the current stream (no synchronisation) and count one
    launch in ``matmul.launches``; ``meta`` operands give the output's
    shape.
    """
    _check_tile(bm, bn, bk)
    _check(a, b)
    registry.check_device("matmul", a.device)
    return OP(a, b, bm, bn, bk)


def _resolve(args: Sequence[Any], bm: int = 128, bn: int = 128,
             bk: int = 16):
    """Executable-cache hook: the launcher for this tile (checked against
    the table), building the kernel library first when the operands live
    on the card."""
    _check_tile(bm, bn, bk)
    if any(str(getattr(x, "device", "")).startswith("cuda") for x in args):
        build.library()
    return functools.partial(matmul, bm=bm, bn=bn, bk=bk)


matmul.launches = 0
matmul.resolve = _resolve
