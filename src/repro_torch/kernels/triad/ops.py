"""STREAM TRIAD, C = A + gamma*B: the hand-written CUDA kernel's wrapper
and its plain PyTorch version.

The kernel (``csrc/triad.cu``) replaces the Pallas ``triad_pallas`` of
the JAX package; it streams flat 1-D vectors, so the (rows, 1024)
reshaping and padding of the TPU version have no counterpart here. On a
CPU tensor :func:`triad` runs :func:`triad_ref`; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Any, Sequence

import torch

from .. import build

__all__ = ["bytes_moved", "flops", "triad", "triad_ref"]

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


def triad(a: torch.Tensor, b: torch.Tensor, *,
          gamma: float = 3.0) -> torch.Tensor:
    """C = A + gamma*B for two 1-D float32 or bfloat16 vectors.

    CPU operands take :func:`triad_ref`; CUDA operands launch the kernel
    on the current stream (no synchronisation) and count one launch in
    ``triad.launches``.
    """
    _check(a, b)
    dev = a.device
    if dev.type == "cpu":
        return triad_ref(a, b, gamma)
    if dev.type != "cuda":
        raise ValueError(f"triad runs on cpu or cuda, not {dev}")
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
