"""Blocked GEMM, C = A @ B: the hand-written CUDA kernels' wrapper, their
tile tables and their plain PyTorch version.

The kernels replace the Pallas ``matmul_pallas`` of the JAX package, one
per operand dtype; :func:`route` names the one a dtype takes, and each
launch counts one in ``matmul.launches`` and one in its route's entry of
``matmul.route_launches``:

- ``"cuda_cores"``: float32, ``csrc/matmul_f32_sm90.cu``, full f32 on the
  CUDA cores fed by a TMA ring on mbarriers (a producer warp, 8 x 8
  register tiles a consumer thread), at the tiles of :data:`TILES`;
- ``"tensor_cores"``: bfloat16, ``csrc/matmul_sm90.cu``, ``wgmma`` on
  Hopper's tensor cores fed by a TMA ring (exact bf16 products summed in
  f32), at the tiles of :data:`BF16_TILES`.

TMA wants 16-byte aligned rows, so an operand whose row is not a multiple
of 16 bytes (or whose start is not 16-byte aligned) is copied into a
buffer whose row stride is rounded up (:func:`tma_operand`).

The (bm, bn, bk) tile is the autotuner's tunable, as the VMEM tile is on
the TPU; each route's tiles are compiled ahead as a fixed table
(:data:`ROUTE_TILES`) and a tile outside it raises. Ragged edges are
masked inside the kernels, so no operand is padded to a tile. On a CPU
tensor :func:`matmul` runs :func:`matmul_ref`; on a CUDA tensor it
launches its route's kernel or raises. Both go through the op
``repro_torch::matmul`` (:mod:`repro_torch.kernels.registry`). The
CUDA-core design both kernels replaced, ``csrc/baseline/matmul_cuda_cores.cu``,
is outside the kernel library: ``chip_smoke.py`` builds and times it
beside them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Optional, Sequence

import torch

from .. import build, registry
from ..counting import count_launch

__all__ = ["BF16_TILES", "DEFAULT_TILES", "F32_STAGES", "OP", "ROUTE_TILES",
           "TILES", "flops", "matmul", "matmul_ref", "route", "smem_bytes",
           "tiles", "tma_operand"]

#: the compiled (bm, bn, bk) tile table of the float32 route —
#: csrc/matmul_f32_sm90.cu's RT_MATMUL_F32_SM90_TILES lists exactly these
TILES = tuple((bm, bn, bk) for bm in (64, 128) for bn in (64, 128)
              for bk in (8, 16, 32))
#: the compiled (bm, bn, bk) tile table of the bfloat16 route —
#: csrc/matmul_sm90.cu's RT_MATMUL_SM90_TILES lists exactly these
BF16_TILES = tuple((bm, bn, bk) for bm in (64, 128, 256)
                   for bn in (64, 128, 256) for bk in (32, 64)
                   if bm * bn <= 128 * 256)
#: each route's tile table
ROUTE_TILES = {"cuda_cores": TILES, "tensor_cores": BF16_TILES}
#: the tile :func:`matmul` takes when none is given, per route
DEFAULT_TILES = {"cuda_cores": (128, 128, 16), "tensor_cores": (128, 128, 64)}

_ROUTES = {torch.float32: "cuda_cores", torch.bfloat16: "tensor_cores"}
#: each route's launcher name prefix in the kernel library
_LAUNCHER_NAMES = {"cuda_cores": "rt_matmul_f32_sm90",
                   "tensor_cores": "rt_matmul_sm90_bf16"}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)
_MAX_GRID_Y = 65535
#: a block's opt-in shared memory on an H100, which the tensor-core
#: kernel's ring fills (csrc/hopper.cuh's kSmemLimit)
_SMEM_LIMIT = 232448
#: the float32 kernel's ring depth (csrc/matmul_f32_sm90.cu's kStages)
F32_STAGES = 3
#: (dtype, tile) -> ctypes launcher, filled at its first launch
_LAUNCHERS: dict = {}


def route(dtype: torch.dtype) -> str:
    """The kernel that takes ``dtype``: ``"cuda_cores"`` for float32,
    ``"tensor_cores"`` for bfloat16."""
    try:
        return _ROUTES[dtype]
    except KeyError:
        raise TypeError(f"matmul takes float32 or bfloat16 operands, not "
                        f"{dtype}") from None


def tiles(dtype: torch.dtype) -> tuple:
    """The compiled tile table of ``dtype``'s route."""
    return ROUTE_TILES[route(dtype)]


def smem_bytes(bm: int, bn: int, bk: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory one block of ``dtype``'s kernel takes at
    tile (bm, bn, bk): 1024 bytes to align the ring, then its stages, each
    A's (bm, bk) and B's (bk, bn) slice and two 8-byte mbarriers. float32
    (``matmul_f32_sm90.cu``): :data:`F32_STAGES` stages, so the ring
    follows the tile. bfloat16 (``matmul_sm90.cu``): as many stages as fit
    the H100's 232,448 bytes. The search-space constraint holds it to the
    device's per-block limit (the counterpart of the TPU's ``vmem_bytes``
    budget)."""
    if route(dtype) == "cuda_cores":
        return 1024 + F32_STAGES * ((bm * bk + bk * bn) * 4 + 16)
    stage = (bm * bk + bk * bn) * 2 + 16
    return 1024 + (_SMEM_LIMIT - 1024) // stage * stage


def flops(m: int, n: int, k: int) -> float:
    """FLOPs of one C = A@B evaluation (the paper's DGEMM FLOP count)."""
    return 2.0 * m * n * k


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: f32 product cast to the input dtype, matching
    the kernels' dtype policy."""
    return (a.float() @ b.float()).to(a.dtype)


def tma_operand(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``x`` (row-major, 2-D) as the kernels' TMA loads take it, and its
    row stride in elements: rows a multiple of 16 bytes apart (8 bf16 or 4
    f32 elements) from a 16-byte aligned start. An operand that is not so
    is copied into a buffer whose row stride is rounded up to 16 bytes;
    the kernels never read the columns past the operand's own."""
    rows, cols = x.shape
    per = 16 // x.element_size()
    ld = -(-cols // per) * per
    if ld == cols and x.data_ptr() % 16 == 0:
        return x, ld
    buf = x.new_empty((rows, ld))
    buf[:, :cols].copy_(x)
    return buf, ld


def _check_tile(bm: int, bn: int, bk: int, dtype: torch.dtype) -> None:
    table = tiles(dtype)
    if (bm, bn, bk) not in table:
        raise ValueError(f"tile ({bm}, {bn}, {bk}) is not in the compiled "
                         f"table {table} of {dtype}")


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul wants (m, k) @ (k, n), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _ROUTES:
        raise TypeError(f"matmul takes float32 or bfloat16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, "
                         f"{b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul operands must be contiguous (row-major)")


def _launcher(path: str, bm: int, bn: int, bk: int):
    key = (path, bm, bn, bk)
    fn = _LAUNCHERS.get(key)
    if fn is None:
        fn = _LAUNCHERS[key] = build.kernel_fn(
            f"{_LAUNCHER_NAMES[path]}_{bm}x{bn}x{bk}", _ARGTYPES)
    return fn


def _launch(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
            bk: int) -> torch.Tensor:
    """The op's CUDA implementation: one launch of the route's kernel on
    the current stream (no synchronisation), counted in
    ``matmul.launches`` and its route's ``matmul.route_launches``."""
    dev = a.device
    m, k = a.shape
    n = b.shape[1]
    path = route(a.dtype)
    _check_tile(bm, bn, bk, a.dtype)
    if -(-m // bm) > _MAX_GRID_Y:
        raise ValueError(f"m={m} needs more than {_MAX_GRID_Y} row blocks "
                         f"of {bm}")
    fn = _launcher(path, bm, bn, bk)
    c = torch.empty((m, n), dtype=a.dtype, device=dev)
    stream = build.current_stream_ptr(dev.index)
    a_, lda = tma_operand(a)
    b_, ldb = tma_operand(b)
    rc = fn(a_.data_ptr(), b_.data_ptr(), c.data_ptr(), m, n, k, lda, ldb,
            dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"matmul {path} kernel launch failed: CUDA "
                           f"error {rc}")
    count_launch(matmul, path)
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


#: ``repro_torch::matmul``: the route's kernel at one tile (CUDA),
#: :func:`matmul_ref` (CPU)
OP = registry.define(
    "matmul", "(Tensor a, Tensor b, int bm, int bn, int bk) -> Tensor",
    cpu=_plain, cuda=_launch, fake=_fake, flops=_op_flops)


def _tile(dtype: torch.dtype, bm: Optional[int], bn: Optional[int],
          bk: Optional[int]) -> tuple[int, int, int]:
    """The given tile, its missing sizes from ``dtype``'s default."""
    default = DEFAULT_TILES[route(dtype)]
    return tuple(d if v is None else v for v, d in zip((bm, bn, bk),
                                                       default))


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: Optional[int] = None,
           bn: Optional[int] = None,
           bk: Optional[int] = None) -> torch.Tensor:
    """C = A @ B with a (bm, bn, bk) tile from the operands' route's
    table (:func:`tiles`; :data:`DEFAULT_TILES` fills a size not given),
    through the op ``repro_torch::matmul``.

    CPU operands take :func:`matmul_ref`; CUDA operands launch the
    route's kernel on the current stream (no synchronisation) and count
    one launch in ``matmul.launches`` and one in
    ``matmul.route_launches[route(dtype)]``; ``meta`` operands give the
    output's shape.
    """
    _check(a, b)
    bm, bn, bk = _tile(a.dtype, bm, bn, bk)
    _check_tile(bm, bn, bk, a.dtype)
    registry.check_device("matmul", a.device)
    return OP(a, b, bm, bn, bk)


def _resolve(args: Sequence[Any], bm: Optional[int] = None,
             bn: Optional[int] = None, bk: Optional[int] = None):
    """Executable-cache hook: the launcher for this tile (checked against
    the operands' table), building the kernel library first when the
    operands live on the card."""
    dtype = args[0].dtype
    bm, bn, bk = _tile(dtype, bm, bn, bk)
    _check_tile(bm, bn, bk, dtype)
    if any(str(getattr(x, "device", "")).startswith("cuda") for x in args):
        build.library()
    return functools.partial(matmul, bm=bm, bn=bn, bk=bk)


matmul.launches = 0
#: launches per kernel: "cuda_cores" (float32) and "tensor_cores" (bfloat16)
matmul.route_launches = {path: 0 for path in ROUTE_TILES}
matmul.resolve = _resolve
