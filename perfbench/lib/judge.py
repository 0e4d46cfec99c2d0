"""The numbers that decide ``correct``, and their limits.

Every cell has a file ``perfbench/limits/<cell>.json`` that maps each
number it compares to its limit; ``PERF.md`` gives the readings each
limit was set from. A number passes when it is finite and at most its
limit.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch

__all__ = ["passed", "rel_rms", "served_gap", "verdict"]


def served_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """The widest gap by which a served token's reference logit lies
    below the reference's best at its position: ``ref_logits`` (..., V)
    float32, ``served`` (...) token ids."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served.long()[..., None])[..., 0]
    return float((best - got).max())


def rel_rms(x: torch.Tensor, ref: torch.Tensor) -> float:
    """||x - ref|| / ||ref||, in float64."""
    x, ref = x.double(), ref.double()
    return float((x - ref).norm() / ref.norm().clamp(min=1e-300))


def passed(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit


def verdict(values: Mapping[str, float], lim: Mapping[str, float]) -> dict:
    """Each number beside its limit: {name: {"value", "limit"}}."""
    missing = set(lim) - set(values)
    if missing:
        raise KeyError(f"no reading of {sorted(missing)}")
    return {name: {"value": float(values[name]), "limit": lim[name]}
            for name in lim}
