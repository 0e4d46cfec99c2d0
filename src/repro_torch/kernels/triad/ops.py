"""STREAM TRIAD, C = A + gamma*B: the hand-written CUDA kernel's wrapper
and its plain PyTorch version.

The kernel (``csrc/triad.cu``) replaces the Pallas ``triad_pallas`` of
the JAX package; it streams flat 1-D vectors, so the (rows, 1024)
reshaping and padding of the TPU version have no counterpart here. On a
CPU tensor :func:`triad` runs :func:`triad_ref`; on a CUDA tensor it
launches the kernel or raises. Both go through the op
``repro_torch::triad`` (:mod:`repro_torch.kernels.registry`).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Any, Sequence

import torch

from .. import build, registry

__all__ = ["OP", "bytes_moved", "flops", "triad", "triad_ref"]

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_COUNT_LOCK = threading.Lock()
_LAUNCHERS: dict = {}   # dtype -> ctypes launcher, filled at its first launch


def triad_ref(a: torch.Tensor, b: torch.Tensor,
              gamma: float = 3.0) -> torch.Tensor:
    """The plain version: C = A + gamma*B in the operands' dtype."""
    return a + gamma * b


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 1 or a.shape != b.shape:
        raise ValueError(f"triad wants two equal 1-D vectors, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"triad takes float32 or bfloat16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, "
                         f"{b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("triad operands must be contiguous")


def _launch(a: torch.Tensor, b: torch.Tensor, gamma: float) -> torch.Tensor:
    """The op's CUDA implementation: one launch of the kernel on the
    current stream (no synchronisation), counted in ``triad.launches``."""
    dev = a.device
    fn = _LAUNCHERS.get(a.dtype)
    if fn is None:
        fn = _LAUNCHERS[a.dtype] = build.kernel_fn(
            f"rt_triad_{_DTYPES[a.dtype]}", _ARGTYPES)
    c = torch.empty_like(a)
    rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), a.numel(),
            float(gamma), dev.index, build.current_stream_ptr(dev.index))
    if rc != 0:
        raise RuntimeError(f"triad kernel launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        triad.launches += 1
    return c


def _fake(a: torch.Tensor, b: torch.Tensor, gamma: float) -> torch.Tensor:
    return torch.empty_like(a)


def _op_flops(a_shape, b_shape, gamma, *, out_shape=None, **_) -> float:
    return flops(math.prod(a_shape))


#: ``repro_torch::triad``: the kernel (CUDA), :func:`triad_ref` (CPU)
OP = registry.define("triad", "(Tensor a, Tensor b, float gamma) -> Tensor",
                     cpu=triad_ref, cuda=_launch, fake=_fake,
                     flops=_op_flops)


def triad(a: torch.Tensor, b: torch.Tensor, *,
          gamma: float = 3.0) -> torch.Tensor:
    """C = A + gamma*B for two 1-D float32 or bfloat16 vectors, through
    the op ``repro_torch::triad``.

    CPU operands take :func:`triad_ref`; CUDA operands launch the kernel
    on the current stream (no synchronisation) and count one launch in
    ``triad.launches``; ``meta`` operands give the output's shape.
    """
    _check(a, b)
    registry.check_device("triad", a.device)
    return OP(a, b, float(gamma))


def _resolve(args: Sequence[Any], gamma: float = 3.0):
    """Executable-cache hook: the launcher for these operands (building
    the kernel library first when they live on the card)."""
    if any(str(getattr(x, "device", "")).startswith("cuda") for x in args):
        build.library()
    return functools.partial(triad, gamma=gamma)


triad.launches = 0
triad.resolve = _resolve


def bytes_moved(n_elements: int, dtype_bytes: int) -> float:
    """3 words per element (load A, load B, store C) — paper Sec. III-B."""
    return 3.0 * n_elements * dtype_bytes


def flops(n_elements: int) -> float:
    """2 FLOP per element (mul + add)."""
    return 2.0 * n_elements
