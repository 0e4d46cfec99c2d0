"""Decoder-only LM assembly, dense GQA (the JAX package's
``models/transformer.py``).

Parameters keep the reference's stacked layout (a leading "layers" axis
on every block weight); the reference scans over it, the port loops
over the layers, each optionally checkpointed (``StepConfig.remat``).
The dense family's train step, prefill and decode are ported; MoE and
the VLM cross-attention stack raise ``NotImplementedError`` naming their
``ROADMAP.md`` entry (the Mamba2 families live in
:mod:`repro_torch.models.hybrid`).

Prefill computes attention with the plain path whatever
``StepConfig.use_flash`` says, as the reference does
(``_self_block(..., collect_kv=True)``); decode updates the KV cache in
place (:func:`repro_torch.models.layers.attention_decode`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import layers as L
from .config import ModelConfig
from .params import ParamDef

__all__ = ["StepConfig", "kv_cache_spec", "lm_decode", "lm_defs",
           "lm_hidden", "lm_loss", "lm_prefill"]

_MOE_TODO = ("MoE models are not ported yet (ROADMAP.md, 'Still to port': "
             "MoE)")
_VLM_TODO = ("the VLM cross-attention stack is not ported yet (ROADMAP.md, "
             "'Still to port': VLM)")


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Execution knobs (all are autotuner search dimensions)."""

    use_flash: bool = False       # flash kernel vs the plain attention
    flash_block_q: int = 512      # flash-attention logical q block
    flash_block_k: int = 512      # flash-attention logical kv block
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    loss_chunk: int = 512
    microbatches: int = 1
    inference: bool = False       # prefill/decode: drop-free MoE routing
    grad_bf16: bool = False       # cast grads before sync (halves traffic)


def _stacked_norm(cfg: ModelConfig, layers: int) -> ParamDef:
    return ParamDef(shape=(layers, cfg.d_model), logical=("layers", "embed_r"),
                    init="ones", dtype=cfg.tdtype)


def _block_defs(cfg: ModelConfig, layers: int) -> dict:
    if cfg.n_experts:
        raise NotImplementedError(_MOE_TODO)
    return {"ln1": _stacked_norm(cfg, layers),
            "attn": L.attention_defs(cfg, layers=layers),
            "ln2": _stacked_norm(cfg, layers),
            "mlp": L.mlp_defs(cfg, layers=layers)}


def lm_defs(cfg: ModelConfig) -> dict:
    """Dense decoder-only parameter tree."""
    return {"embed": L.embedding_defs(cfg),
            "layers": _block_defs(cfg, cfg.n_layers),
            "ln_f": L.norm_defs(cfg)}


# ---------------------------------------------------------------------------
# Block bodies
# ---------------------------------------------------------------------------


def _ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig,
         step: StepConfig = StepConfig()) -> torch.Tensor:
    if cfg.n_experts:
        raise NotImplementedError(_MOE_TODO)
    return L.apply_mlp(lp["mlp"], x, cfg)


def _self_block(h: torch.Tensor, lp: dict, cfg: ModelConfig,
                step: StepConfig, *, collect_kv: bool = False):
    """One pre-norm block: attention then MLP, each with a residual. With
    ``collect_kv`` (prefill) the attention is the plain path, as in the
    reference, and the block also returns this layer's roped (K, V)."""
    a_in = L.apply_norm(lp["ln1"], h, cfg)
    if collect_kv:
        q = torch.einsum("bsd,dhk->bhsk", a_in, lp["attn"]["wq"])
        k = torch.einsum("bsd,dhk->bhsk", a_in, lp["attn"]["wk"])
        v = torch.einsum("bsd,dhk->bhsk", a_in, lp["attn"]["wv"])
        pos = torch.arange(h.shape[1], device=h.device)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
        out = L._attend(q, k, v, causal=True, window=cfg.window)
        a = torch.einsum("bhsk,hkd->bsd", out, lp["attn"]["wo"])
        kv = (k, v)
    else:
        a = L.attention_full(lp["attn"], a_in, cfg, causal=True,
                             window=cfg.window, use_flash=step.use_flash,
                             block_q=step.flash_block_q,
                             block_k=step.flash_block_k)
    h = h + a
    h = h + _ffn(lp, L.apply_norm(lp["ln2"], h, cfg), cfg, step)
    return (h, kv) if collect_kv else h


def _maybe_remat(fn, step: StepConfig):
    """``fn`` itself, or ``fn`` checkpointed (only its inputs are kept for
    the backward pass: the reference's ``nothing_saveable`` policy, the
    one policy ported)."""
    if not step.remat:
        return fn
    if step.remat_policy != "nothing_saveable":
        raise NotImplementedError(
            f"remat policy {step.remat_policy!r}: only 'nothing_saveable' "
            f"is ported")
    return lambda *args: L.checkpointed(fn, *args)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s slice of a stacked parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def lm_hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
              step: StepConfig) -> torch.Tensor:
    """Token ids -> final hidden states (B, S, D)."""
    if cfg.family == "vlm":
        raise NotImplementedError(_VLM_TODO)
    h = L.embed_tokens(params["embed"], tokens, cfg)
    body = _maybe_remat(lambda carry, lp: _self_block(carry, lp, cfg, step),
                        step)
    for i in range(params["layers"]["ln1"].shape[0]):
        h = body(h, _layer(params["layers"], i))
    return L.apply_norm(params["ln_f"], h, cfg)


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            step: StepConfig) -> torch.Tensor:
    if cfg.n_experts:
        raise NotImplementedError(_MOE_TODO)
    tokens = batch["tokens"]
    h = lm_hidden(params, tokens, cfg, step)
    targets, mask = L.next_token_targets(tokens)
    return L.cross_entropy_loss(params["embed"], h, targets, cfg,
                                chunk=step.loss_chunk, mask=mask)


# ---------------------------------------------------------------------------
# Prefill & decode
# ---------------------------------------------------------------------------


def kv_cache_spec(cfg: ModelConfig, batch: int, length: int,
                  layers: Optional[int] = None) -> L.KVCacheSpec:
    return L.KVCacheSpec(layers=layers or cfg.n_layers, batch=batch,
                         kv_heads=cfg.n_kv_heads, length=length,
                         head_dim=cfg.head_dim_, dtype=cfg.tdtype)


def lm_prefill(params: dict, batch: dict, cfg: ModelConfig,
               step: StepConfig) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also builds the decode cache: per layer
    the roped K/V, with position tags 0..S-1, each layer checkpointed
    under ``step.remat`` as in the reference. Returns (last-position
    logits, cache)."""
    if cfg.family == "vlm":
        raise NotImplementedError(_VLM_TODO)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = L.embed_tokens(params["embed"], tokens, cfg)
    block = _maybe_remat(
        lambda carry, lp: _self_block(carry, lp, cfg, step, collect_kv=True),
        step)
    kvs = []
    for i in range(params["layers"]["ln1"].shape[0]):
        h, kv = block(h, _layer(params["layers"], i))
        kvs.append(kv)
    h = L.apply_norm(params["ln_f"], h, cfg)
    logits = L.logits_fn(params["embed"], h[:, -1:], cfg)
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
    cache = {"attn": {"k": torch.stack([k for k, _ in kvs]),
                      "v": torch.stack([v for _, v in kvs]),
                      "pos": pos.expand(len(kvs), B, S).clone()}}
    return logits, cache


def lm_decode(params: dict, tokens: torch.Tensor, cache: dict, pos,
              cfg: ModelConfig, step: StepConfig
              ) -> tuple[torch.Tensor, dict]:
    """One-token decode. tokens: (B, 1); ``pos`` an int or a 0-d integer
    tensor on the cache's device. Each layer's K/V and position tag are
    written in place into ``cache["attn"]``, which is returned with the
    logits (B, 1, V)."""
    if cfg.family == "vlm":
        raise NotImplementedError(_VLM_TODO)
    h = L.embed_tokens(params["embed"], tokens, cfg)
    pos = L.decode_position(pos, h.device)
    attn = cache["attn"]
    for i in range(params["layers"]["ln1"].shape[0]):
        lp = _layer(params["layers"], i)
        a_in = L.apply_norm(lp["ln1"], h, cfg)
        a, _ = L.attention_decode(lp["attn"], a_in, _layer(attn, i), pos,
                                  cfg, window=cfg.window)
        h = h + a
        h = h + _ffn(lp, L.apply_norm(lp["ln2"], h, cfg), cfg, step)
    h = L.apply_norm(params["ln_f"], h, cfg)
    logits = L.logits_fn(params["embed"], h, cfg)
    return logits, cache
