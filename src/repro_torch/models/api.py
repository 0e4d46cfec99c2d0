"""Unified model API (the JAX package's ``models/api.py``): one entry
point per step kind, dispatched by family.

    param_defs(cfg)                      -> ParamDef tree
    loss_fn(params, batch, cfg, step)    -> scalar loss            (train)
    prefill_fn(params, batch, cfg, step) -> (logits, cache)        (prefill)
    decode_fn(params, batch, cache, pos, cfg, step) -> (logits, cache)
    cache_shapes(cfg, shape)             -> tree of ShapeDtype
    cache_init(cfg, shape, device)       -> zero cache
    extend_cache(cache, extra)           -> cache with room for more tokens

Ported: the train step, prefill and decode of the ``dense``, ``ssm``
and ``hybrid`` families. The other families raise
``NotImplementedError`` naming their ``ROADMAP.md`` entry. ``pos`` is a
Python int or a 0-d integer tensor on the cache's device; decode writes
the attention KV caches in place and returns them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import hybrid, layers, transformer
from .config import ModelConfig, WorkloadShape, cache_len
from .transformer import StepConfig

__all__ = ["cache_init", "cache_shapes", "decode_fn", "extend_cache",
           "loss_fn", "param_defs", "prefill_fn"]

#: the ROADMAP.md entry ("Still to port") of each family not ported yet
_FAMILY_TODO = {
    "moe": "MoE",
    "vlm": "VLM",
    "encdec": "enc-dec",
}
_PORTED = ("dense", "ssm", "hybrid")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family in _PORTED:
        return
    if cfg.family in _FAMILY_TODO:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, 'Still "
            f"to port': {_FAMILY_TODO[cfg.family]})")
    raise ValueError(f"unknown family {cfg.family!r}")


def param_defs(cfg: ModelConfig) -> dict:
    _require_ported(cfg)
    if cfg.family == "ssm":
        return hybrid.ssm_lm_defs(cfg)
    if cfg.family == "hybrid":
        return hybrid.hybrid_lm_defs(cfg)
    return transformer.lm_defs(cfg)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            step: StepConfig) -> torch.Tensor:
    _require_ported(cfg)
    if cfg.family in ("ssm", "hybrid"):
        tokens = batch["tokens"]
        h = hybrid.hidden(params, tokens, cfg, step)
        targets, mask = layers.next_token_targets(tokens)
        return layers.cross_entropy_loss(params["embed"], h, targets, cfg,
                                         chunk=step.loss_chunk, mask=mask)
    return transformer.lm_loss(params, batch, cfg, step)


def prefill_fn(params: dict, batch: dict, cfg: ModelConfig,
               step: StepConfig) -> tuple[torch.Tensor, dict]:
    _require_ported(cfg)
    step = dataclasses.replace(step, inference=True)
    if cfg.family in ("ssm", "hybrid"):
        return hybrid.prefill(params, batch, cfg, step)
    return transformer.lm_prefill(params, batch, cfg, step)


def decode_fn(params: dict, batch: dict, cache: dict, pos,
              cfg: ModelConfig, step: StepConfig) -> tuple[torch.Tensor,
                                                           dict]:
    _require_ported(cfg)
    step = dataclasses.replace(step, inference=True)
    tokens = batch["tokens"]
    if cfg.family in ("ssm", "hybrid"):
        return hybrid.decode(params, tokens, cache, pos, cfg, step)
    return transformer.lm_decode(params, tokens, cache, pos, cfg, step)


def cache_shapes(cfg: ModelConfig, shape: WorkloadShape) -> dict:
    """Shapes and dtypes of the decode cache of one workload cell."""
    _require_ported(cfg)
    B = shape.global_batch
    length = cache_len(cfg, shape)
    if cfg.family in ("ssm", "hybrid"):
        return hybrid.cache_shapes(cfg, B, length)
    return {"attn": transformer.kv_cache_spec(cfg, B, length).shape_tree()}


def cache_init(cfg: ModelConfig, shape: WorkloadShape,
               device: "str | torch.device" = "cuda") -> dict:
    """Zero-initialized cache on ``device`` (attention position tags -1:
    every slot empty)."""

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key == "pos":
            return torch.full(node.shape, -1, dtype=torch.int32,
                              device=device)
        return torch.zeros(node.shape, dtype=node.dtype, device=device)

    return walk(cache_shapes(cfg, shape))


def extend_cache(cache: dict, extra: int) -> dict:
    """Grow every attention KV cache by ``extra`` slots (prefill allocates
    prompt-length caches; serving needs room for generated tokens). The
    new position tags are -1 (empty)."""

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"k", "v", "pos"}:
                return {"k": F.pad(node["k"], (0, 0, 0, extra)),
                        "v": F.pad(node["v"], (0, 0, 0, extra)),
                        "pos": F.pad(node["pos"], (0, extra), value=-1)}
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(cache)
