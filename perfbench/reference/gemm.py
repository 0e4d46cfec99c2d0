"""The GEMM's reference: C = A @ B in float64, and its control, the same
product in TF32 (operands rounded to TF32, float32 accumulation)."""

from __future__ import annotations

import torch

from .common import cast, exact_float32

__all__ = ["product"]


def product(a: torch.Tensor, b: torch.Tensor,
            precision: str = "f64") -> torch.Tensor:
    """A @ B: in float64 (``f64``), or in ``tf32`` for the control."""
    if precision == "f64":
        return a.double() @ b.double()
    with exact_float32():
        return cast(a, precision) @ cast(b, precision)
