"""Decoder-only LM assembly: dense GQA, MoE, and VLM (cross-attention)
variants (the JAX package's ``models/transformer.py``).

Parameters keep the reference's stacked layout (a leading "layers" axis
on every block weight); the reference scans over it, the port loops
over the layers, each optionally checkpointed (``StepConfig.remat``).
An MoE model's blocks hold experts (:mod:`repro_torch.models.moe`) in
place of the MLP. The VLM variant runs groups of ``cross_attn_every - 1``
self blocks, each group followed by one cross-attention block over the
image embeddings: self layer j belongs to group ``j // (cross_attn_every
- 1)``, and its KV cache is group-major, (n_self, B, Hkv, S, Dh). Cross
blocks run the plain attention, and decode recomputes their K/V from the
image embeddings at every step (the cache holds no cross entry), as the
reference does. The Mamba2 families live in
:mod:`repro_torch.models.hybrid`.

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
from . import moe as moe_lib
from .config import ModelConfig
from .params import ParamDef

__all__ = ["StepConfig", "kv_cache_spec", "lm_decode", "lm_defs",
           "lm_hidden", "lm_loss", "lm_prefill", "vlm_defs", "vlm_groups",
           "vlm_prefill"]


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
    d: dict = {"ln1": _stacked_norm(cfg, layers),
               "attn": L.attention_defs(cfg, layers=layers),
               "ln2": _stacked_norm(cfg, layers)}
    if cfg.n_experts:
        d["moe"] = moe_lib.moe_defs(cfg, layers=layers)
    else:
        d["mlp"] = L.mlp_defs(cfg, layers=layers)
    return d


def lm_defs(cfg: ModelConfig) -> dict:
    """Dense / MoE decoder-only parameter tree."""
    return {"embed": L.embedding_defs(cfg),
            "layers": _block_defs(cfg, cfg.n_layers),
            "ln_f": L.norm_defs(cfg)}


def vlm_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(cross blocks, self blocks per group) of a VLM config: every
    ``cross_attn_every``-th layer is a cross block, which must leave a
    whole number of self blocks per group (the reference's reshape)."""
    n_cross = cfg.n_layers // cfg.cross_attn_every
    per_group = cfg.cross_attn_every - 1
    if n_cross * per_group != cfg.n_layers - n_cross:
        raise ValueError(f"{cfg.n_layers} layers are not {n_cross} groups "
                         f"of {per_group} self blocks and a cross block")
    return n_cross, per_group


def vlm_defs(cfg: ModelConfig) -> dict:
    """Self blocks + every-Nth cross-attention blocks (Llama-3.2-Vision)."""
    n_cross, per_group = vlm_groups(cfg)
    return {
        "embed": L.embedding_defs(cfg),
        "self_layers": _block_defs(cfg, n_cross * per_group),
        "cross_layers": {
            "ln1": _stacked_norm(cfg, n_cross),
            "attn": L.attention_defs(cfg, layers=n_cross),
            "ln2": _stacked_norm(cfg, n_cross),
            "mlp": L.mlp_defs(cfg, layers=n_cross),
        },
        "ln_f": L.norm_defs(cfg),
    }


# ---------------------------------------------------------------------------
# Block bodies
# ---------------------------------------------------------------------------


def _ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig,
         step: StepConfig = StepConfig()) -> torch.Tensor:
    if cfg.n_experts:
        return moe_lib.apply_moe(lp["moe"], x, cfg, drop=not step.inference)
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


def _cross_block(h: torch.Tensor, lp: dict, ctx: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """One cross-attention block: the plain attention of ``h`` over
    ``ctx`` (the image embeddings; no rope, no mask), then the MLP."""
    a_in = L.apply_norm(lp["ln1"], h, cfg)
    h = h + L.attention_full(lp["attn"], a_in, cfg, kv_x=ctx, causal=False,
                             rope=False, use_flash=False)
    h = h + L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], h, cfg), cfg)
    return h


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
              step: StepConfig,
              image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids -> final hidden states (B, S, D); a VLM config also
    takes the image embeddings (B, n_image_tokens, D)."""
    h = L.embed_tokens(params["embed"], tokens, cfg)
    if cfg.family == "vlm":
        h = _vlm_hidden(params, h, image_embeds, cfg, step)
    else:
        body = _maybe_remat(
            lambda carry, lp: _self_block(carry, lp, cfg, step), step)
        for i in range(params["layers"]["ln1"].shape[0]):
            h = body(h, _layer(params["layers"], i))
    return L.apply_norm(params["ln_f"], h, cfg)


def _vlm_hidden(params: dict, h: torch.Tensor, image_embeds: torch.Tensor,
                cfg: ModelConfig, step: StepConfig) -> torch.Tensor:
    n_cross, per_group = vlm_groups(cfg)
    self_body = _maybe_remat(
        lambda carry, lp: _self_block(carry, lp, cfg, step), step)
    cross_body = _maybe_remat(
        lambda carry, lp: _cross_block(carry, lp, image_embeds, cfg), step)
    for g in range(n_cross):
        for j in range(g * per_group, (g + 1) * per_group):
            h = self_body(h, _layer(params["self_layers"], j))
        h = cross_body(h, _layer(params["cross_layers"], g))
    return h


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            step: StepConfig) -> torch.Tensor:
    tokens = batch["tokens"]
    h = lm_hidden(params, tokens, cfg, step,
                  image_embeds=batch.get("image_embeds"))
    targets, mask = L.next_token_targets(tokens)
    loss = L.cross_entropy_loss(params["embed"], h, targets, cfg,
                                chunk=step.loss_chunk, mask=mask)
    if cfg.n_experts:
        # the router load-balance aux loss of the first layer over the
        # token embeddings (the reference's cheap proxy), weight 0.01
        h0 = L.embed_tokens(params["embed"], tokens, cfg)
        router0 = _layer(params["layers"]["moe"], 0)
        loss = loss + 0.01 * moe_lib.aux_load_balance_loss(router0, h0, cfg)
    return loss


# ---------------------------------------------------------------------------
# Prefill & decode
# ---------------------------------------------------------------------------


def kv_cache_spec(cfg: ModelConfig, batch: int, length: int,
                  layers: Optional[int] = None) -> L.KVCacheSpec:
    return L.KVCacheSpec(layers=layers or cfg.n_layers, batch=batch,
                         kv_heads=cfg.n_kv_heads, length=length,
                         head_dim=cfg.head_dim_, dtype=cfg.tdtype)


def _prefill_cache(kvs: list, batch: int, seq: int,
                   device: torch.device) -> dict:
    """The decode cache of a prefill: each self layer's roped (K, V),
    stacked, with position tags 0..S-1."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    return {"attn": {"k": torch.stack([k for k, _ in kvs]),
                     "v": torch.stack([v for _, v in kvs]),
                     "pos": pos.expand(len(kvs), batch, seq).clone()}}


def lm_prefill(params: dict, batch: dict, cfg: ModelConfig,
               step: StepConfig) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also builds the decode cache: per layer
    the roped K/V, with position tags 0..S-1, each layer checkpointed
    under ``step.remat`` as in the reference. Returns (last-position
    logits, cache)."""
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
    return logits, _prefill_cache(kvs, B, S, tokens.device)


def vlm_prefill(params: dict, batch: dict, cfg: ModelConfig,
                step: StepConfig) -> tuple[torch.Tensor, dict]:
    """VLM prefill: the self layers' K/V collected group by group (the
    cache holds only the n_self self layers). Returns (last-position
    logits, cache)."""
    tokens, image_embeds = batch["tokens"], batch["image_embeds"]
    B, S = tokens.shape
    n_cross, per_group = vlm_groups(cfg)
    h = L.embed_tokens(params["embed"], tokens, cfg)
    kvs = []
    for g in range(n_cross):
        for j in range(g * per_group, (g + 1) * per_group):
            h, kv = _self_block(h, _layer(params["self_layers"], j), cfg,
                                step, collect_kv=True)
            kvs.append(kv)
        h = _cross_block(h, _layer(params["cross_layers"], g), image_embeds,
                         cfg)
    h = L.apply_norm(params["ln_f"], h, cfg)
    logits = L.logits_fn(params["embed"], h[:, -1:], cfg)
    return logits, _prefill_cache(kvs, B, S, tokens.device)


def _decode_block(h: torch.Tensor, lp: dict, layer_cache: dict,
                  pos: torch.Tensor, cfg: ModelConfig, step: StepConfig,
                  window: Optional[int]) -> torch.Tensor:
    a_in = L.apply_norm(lp["ln1"], h, cfg)
    a, _ = L.attention_decode(lp["attn"], a_in, layer_cache, pos, cfg,
                              window=window)
    h = h + a
    return h + _ffn(lp, L.apply_norm(lp["ln2"], h, cfg), cfg, step)


def lm_decode(params: dict, tokens: torch.Tensor, cache: dict, pos,
              cfg: ModelConfig, step: StepConfig,
              image_embeds: Optional[torch.Tensor] = None,
              ) -> tuple[torch.Tensor, dict]:
    """One-token decode. tokens: (B, 1); ``pos`` an int or a 0-d integer
    tensor on the cache's device; a VLM config also takes the image
    embeddings. Each self layer's K/V and position tag are written in
    place into ``cache["attn"]``, which is returned with the logits
    (B, 1, V)."""
    h = L.embed_tokens(params["embed"], tokens, cfg)
    pos = L.decode_position(pos, h.device)
    attn = cache["attn"]
    if cfg.family == "vlm":
        # as the reference: the self layers decode without a window
        n_cross, per_group = vlm_groups(cfg)
        for g in range(n_cross):
            for j in range(g * per_group, (g + 1) * per_group):
                h = _decode_block(h, _layer(params["self_layers"], j),
                                  _layer(attn, j), pos, cfg, step, None)
            h = _cross_block(h, _layer(params["cross_layers"], g),
                             image_embeds, cfg)
    else:
        for i in range(params["layers"]["ln1"].shape[0]):
            h = _decode_block(h, _layer(params["layers"], i),
                              _layer(attn, i), pos, cfg, step, cfg.window)
    h = L.apply_norm(params["ln_f"], h, cfg)
    logits = L.logits_fn(params["embed"], h, cfg)
    return logits, cache
