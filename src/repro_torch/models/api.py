"""Unified model API (the JAX package's ``models/api.py``): one entry
point per step kind, dispatched by family.

    param_defs(cfg)                      -> ParamDef tree
    loss_fn(params, batch, cfg, step)    -> scalar loss            (train)
    loss_and_grads(params, batch, cfg, step) -> (loss, grads)      (train)
    prefill_fn(params, batch, cfg, step) -> (logits, cache)        (prefill)
    decode_fn(params, batch, cache, pos, cfg, step) -> (logits, cache)
    cache_shapes(cfg, shape)             -> tree of ShapeDtype
    cache_logical(cfg)                   -> tree of logical axes
    cache_init(cfg, shape, device)       -> zero cache
    extend_cache(cache, extra)           -> cache with room for more tokens

``pos`` is a Python int or a 0-d integer tensor on the cache's device;
decode writes the attention KV caches in place and returns them.
``batch`` holds ``tokens``, and ``frames`` (enc-dec) or
``image_embeds`` (VLM) where the family takes them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import encdec, hybrid, layers, transformer
from .config import ModelConfig, WorkloadShape, cache_len
from .params import flatten, unflatten
from .transformer import StepConfig

__all__ = ["cache_init", "cache_logical", "cache_shapes", "decode_fn", "extend_cache",
           "loss_and_grads", "loss_fn", "param_defs", "prefill_fn"]


def param_defs(cfg: ModelConfig) -> dict:
    if cfg.family in ("dense", "moe"):
        return transformer.lm_defs(cfg)
    if cfg.family == "vlm":
        return transformer.vlm_defs(cfg)
    if cfg.family == "encdec":
        return encdec.encdec_defs(cfg)
    if cfg.family == "ssm":
        return hybrid.ssm_lm_defs(cfg)
    if cfg.family == "hybrid":
        return hybrid.hybrid_lm_defs(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            step: StepConfig) -> torch.Tensor:
    if cfg.family == "encdec":
        return encdec.loss_fn(params, batch, cfg, step)
    if cfg.family in ("ssm", "hybrid"):
        tokens = batch["tokens"]
        h = hybrid.hidden(params, tokens, cfg, step)
        targets, mask = layers.next_token_targets(tokens)
        return layers.cross_entropy_loss(params["embed"], h, targets, cfg,
                                         chunk=step.loss_chunk, mask=mask)
    return transformer.lm_loss(params, batch, cfg, step)


def loss_and_grads(params: dict, batch: dict, cfg: ModelConfig,
                   step: StepConfig) -> tuple[torch.Tensor, dict]:
    """The loss (detached) and the gradient of every parameter leaf (same
    tree), by ``torch.autograd.grad`` (the reference's
    ``jax.value_and_grad(loss_fn)``): the one loss-and-gradient helper of
    the workloads' train step and ``train.steps.build_train_step``."""
    flat = flatten(params)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in flat.values()]
        loss = loss_fn(unflatten(dict(zip(flat, leaves))), batch, cfg, step)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), unflatten(dict(zip(flat, grads)))


def prefill_fn(params: dict, batch: dict, cfg: ModelConfig,
               step: StepConfig) -> tuple[torch.Tensor, dict]:
    step = dataclasses.replace(step, inference=True)
    if cfg.family == "encdec":
        return encdec.prefill(params, batch, cfg, step)
    if cfg.family in ("ssm", "hybrid"):
        return hybrid.prefill(params, batch, cfg, step)
    if cfg.family == "vlm":
        return transformer.vlm_prefill(params, batch, cfg, step)
    return transformer.lm_prefill(params, batch, cfg, step)


def decode_fn(params: dict, batch: dict, cache: dict, pos,
              cfg: ModelConfig, step: StepConfig) -> tuple[torch.Tensor,
                                                           dict]:
    step = dataclasses.replace(step, inference=True)
    tokens = batch["tokens"]
    if cfg.family == "encdec":
        return encdec.decode(params, tokens, cache, pos, cfg, step)
    if cfg.family in ("ssm", "hybrid"):
        return hybrid.decode(params, tokens, cache, pos, cfg, step)
    return transformer.lm_decode(params, tokens, cache, pos, cfg, step,
                                 image_embeds=batch.get("image_embeds"))


def cache_shapes(cfg: ModelConfig, shape: WorkloadShape) -> dict:
    """Shapes and dtypes of the decode cache of one workload cell."""
    B = shape.global_batch
    length = cache_len(cfg, shape)
    if cfg.family == "encdec":
        return encdec.cache_shapes(cfg, B, length)
    if cfg.family in ("ssm", "hybrid"):
        return hybrid.cache_shapes(cfg, B, length)
    if cfg.family == "vlm":
        n_cross, per_group = transformer.vlm_groups(cfg)
        return {"attn": transformer.kv_cache_spec(
            cfg, B, length, layers=n_cross * per_group).shape_tree()}
    return {"attn": transformer.kv_cache_spec(cfg, B, length).shape_tree()}


def cache_logical(cfg: ModelConfig) -> dict:
    """The logical axes of the decode cache's leaves (same tree as
    :func:`cache_shapes`)."""
    if cfg.family == "encdec":
        return encdec.cache_logical(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return hybrid.cache_logical(cfg)
    return {"attn": layers.KVCacheSpec(1, 1, 1, 1, 1, torch.bfloat16).logical}


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
