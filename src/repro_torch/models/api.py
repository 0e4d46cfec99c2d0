"""Unified model API (the JAX package's ``models/api.py``): one entry
point per step kind, dispatched by family.

    param_defs(cfg)                      -> ParamDef tree
    loss_fn(params, batch, cfg, step)    -> scalar loss            (train)

Only the ``dense`` family is ported. Every other family, and the serving
entry points (``prefill_fn``, ``decode_fn``), raise
``NotImplementedError`` naming their ``ROADMAP.md`` entry.
"""

from __future__ import annotations

import torch

from . import transformer
from .config import ModelConfig
from .transformer import StepConfig

__all__ = ["decode_fn", "loss_fn", "param_defs", "prefill_fn"]

#: the ROADMAP.md entry ("Still to port") of each family not ported yet
_FAMILY_TODO = {
    "moe": "MoE",
    "vlm": "VLM",
    "encdec": "enc-dec",
    "ssm": "the SSM slice",
    "hybrid": "the SSM slice",
}
_SERVING_TODO = ("prefill and decode are not ported yet (ROADMAP.md, "
                 "'Still to port': the serving slice)")


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family == "dense":
        return
    if cfg.family in _FAMILY_TODO:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, 'Still "
            f"to port': {_FAMILY_TODO[cfg.family]})")
    raise ValueError(f"unknown family {cfg.family!r}")


def param_defs(cfg: ModelConfig) -> dict:
    _require_dense(cfg)
    return transformer.lm_defs(cfg)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            step: StepConfig) -> torch.Tensor:
    _require_dense(cfg)
    return transformer.lm_loss(params, batch, cfg, step)


def prefill_fn(params: dict, batch: dict, cfg: ModelConfig,
               step: StepConfig):
    raise NotImplementedError(_SERVING_TODO)


def decode_fn(params: dict, batch: dict, cache: dict, pos, cfg: ModelConfig,
              step: StepConfig):
    raise NotImplementedError(_SERVING_TODO)
