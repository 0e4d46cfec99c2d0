"""Encoder-decoder audio LM, a Whisper-style backbone (the JAX package's
``models/encdec.py``).

The conv frontend is a stub, as in the reference: the batch holds
precomputed frame embeddings ``frames`` (B, n_frames, d_enc). Positions
are sinusoidal (computed, not learned) on both sides, so decode is
defined past Whisper's 448 text positions. Attention is MHA without
rope. The encoder's self-attention and both cross-attentions run the
plain attention; the decoder's causal self-attention takes the flash
kernel with ``step.use_flash`` in the train step. Prefill and decode run
the plain attention, as the reference does.

Decode carries the decoder's self-attention KV cache (written in place,
:func:`repro_torch.models.layers.attention_decode`) and the encoder
output's K/V of every cross-attention, computed once by the prefill:
``cross_k``/``cross_v`` (L, B, Hkv, n_frames, Dh), with the logical axes
of :func:`cache_logical`.
"""

from __future__ import annotations

import torch

from .dots import einsum
from ..distributed.actctx import on_mesh_of
from . import layers as L
from .config import ModelConfig
from .params import ShapeDtype
from .transformer import (StepConfig, _layer, _maybe_remat, _prefill_cache,
                          _stacked_norm, kv_cache_spec)

__all__ = ["cache_shapes", "decode", "decoder_hidden", "encdec_defs",
           "encode", "loss_fn", "prefill"]


def encdec_defs(cfg: ModelConfig) -> dict:
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    return {
        "embed": L.embedding_defs(cfg),
        "enc_layers": {
            "ln1": _stacked_norm(cfg, ne),
            "attn": L.attention_defs(cfg, layers=ne),
            "ln2": _stacked_norm(cfg, ne),
            "mlp": L.mlp_defs(cfg, layers=ne),
        },
        "enc_ln_f": L.norm_defs(cfg),
        "dec_layers": {
            "ln1": _stacked_norm(cfg, nd),
            "attn": L.attention_defs(cfg, layers=nd),
            "lnx": _stacked_norm(cfg, nd),
            "xattn": L.attention_defs(cfg, layers=nd, kv_from=cfg.d_enc),
            "ln2": _stacked_norm(cfg, nd),
            "mlp": L.mlp_defs(cfg, layers=nd),
        },
        "ln_f": L.norm_defs(cfg),
    }


def _with_positions(h: torch.Tensor) -> torch.Tensor:
    """``h`` (B, S, D) plus the sinusoidal table of its S positions."""
    table = L.sinusoidal_positions(h.shape[1], h.shape[2], device=h.device)
    return h + on_mesh_of(table.to(h.dtype), h)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig,
           step: StepConfig) -> torch.Tensor:
    """Frame embeddings (B, n_frames, d_enc) -> encoder output."""

    def body(c, lp):
        a_in = L.apply_norm(lp["ln1"], c, cfg)
        c = c + L.attention_full(lp["attn"], a_in, cfg, causal=False,
                                 rope=False)
        return c + L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], c, cfg),
                               cfg)

    body = _maybe_remat(body, step)
    h = _with_positions(frames)
    for i in range(cfg.n_enc_layers):
        h = body(h, _layer(params["enc_layers"], i))
    return L.apply_norm(params["enc_ln_f"], h, cfg)


def _dec_block(c: torch.Tensor, lp: dict, enc_out: torch.Tensor,
               cfg: ModelConfig, step: StepConfig, *,
               collect_kv: bool = False):
    """One decoder block: causal self-attention, cross-attention over the
    encoder output, MLP. With ``collect_kv`` (prefill) the self-attention
    is the plain path and the block also returns its (K, V)."""
    a_in = L.apply_norm(lp["ln1"], c, cfg)
    if collect_kv:
        q = einsum("bsd,dhk->bhsk", a_in, lp["attn"]["wq"])
        k = einsum("bsd,dhk->bhsk", a_in, lp["attn"]["wk"])
        v = einsum("bsd,dhk->bhsk", a_in, lp["attn"]["wv"])
        out = L._attend(q, k, v, causal=True, window=None)
        c = c + einsum("bhsk,hkd->bsd", out, lp["attn"]["wo"])
        kv = (k, v)
    else:
        c = c + L.attention_full(lp["attn"], a_in, cfg, causal=True,
                                 rope=False, use_flash=step.use_flash,
                                 block_q=step.flash_block_q,
                                 block_k=step.flash_block_k)
    x_in = L.apply_norm(lp["lnx"], c, cfg)
    c = c + L.attention_full(lp["xattn"], x_in, cfg, kv_x=enc_out,
                             causal=False, rope=False)
    c = c + L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], c, cfg), cfg)
    return (c, kv) if collect_kv else c


def decoder_hidden(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
                   cfg: ModelConfig, step: StepConfig) -> torch.Tensor:
    h = _with_positions(L.embed_tokens(params["embed"], tokens, cfg))
    body = _maybe_remat(lambda c, lp: _dec_block(c, lp, enc_out, cfg, step),
                        step)
    for i in range(cfg.n_layers):
        h = body(h, _layer(params["dec_layers"], i))
    return L.apply_norm(params["ln_f"], h, cfg)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            step: StepConfig) -> torch.Tensor:
    enc_out = encode(params, batch["frames"], cfg, step)
    tokens = batch["tokens"]
    h = decoder_hidden(params, tokens, enc_out, cfg, step)
    targets, mask = L.next_token_targets(tokens)
    return L.cross_entropy_loss(params["embed"], h, targets, cfg,
                                chunk=step.loss_chunk, mask=mask)


# ---------------------------------------------------------------------------
# Prefill & decode
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ModelConfig, batch: int, cache_length: int) -> dict:
    cross = ShapeDtype(torch.Size((cfg.n_layers, batch, cfg.n_kv_heads,
                                   cfg.n_frames, cfg.head_dim_)), cfg.tdtype)
    return {"attn": kv_cache_spec(cfg, batch, cache_length).shape_tree(),
            "cross_k": cross, "cross_v": cross}


def cache_logical(cfg: ModelConfig) -> dict:
    kv = ("layers", "cache_batch", "kv_heads", "frames", "head_dim")
    return {"attn": L.KVCacheSpec(1, 1, 1, 1, 1, torch.bfloat16).logical,
            "cross_k": kv, "cross_v": kv}


def prefill(params: dict, batch: dict, cfg: ModelConfig,
            step: StepConfig) -> tuple[torch.Tensor, dict]:
    """Encode the frames, run the decoder over the prompt and build the
    decode cache: each layer's self-attention K/V (position tags
    0..S-1) and its cross-attention K/V of the encoder output. Returns
    (last-position logits, cache)."""
    enc_out = encode(params, batch["frames"], cfg, step)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = _with_positions(L.embed_tokens(params["embed"], tokens, cfg))
    kvs, cross_ks, cross_vs = [], [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        h, kv = _dec_block(h, lp, enc_out, cfg, step, collect_kv=True)
        kvs.append(kv)
        cross_ks.append(einsum("bsd,dhk->bhsk", enc_out,
                                     lp["xattn"]["wk"]))
        cross_vs.append(einsum("bsd,dhk->bhsk", enc_out,
                                     lp["xattn"]["wv"]))
    h = L.apply_norm(params["ln_f"], h, cfg)
    logits = L.logits_fn(params["embed"], h[:, -1:], cfg)
    return logits, {**_prefill_cache(kvs, B, S, tokens.device),
                    "cross_k": torch.stack(cross_ks),
                    "cross_v": torch.stack(cross_vs)}


def decode(params: dict, tokens: torch.Tensor, cache: dict, pos,
           cfg: ModelConfig, step: StepConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode at ``pos`` (an int or a 0-d integer tensor on the
    cache's device; its sinusoidal encoding is computed there). The
    self-attention KV cache is written in place; the cross K/V are
    read. Returns (logits (B, 1, V), cache)."""
    h = L.embed_tokens(params["embed"], tokens, cfg)
    pos = L.decode_position(pos, h)
    h = h + L.sinusoidal_at(pos, cfg.d_model)[None, None].to(h.dtype)
    attn = cache["attn"]
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        a_in = L.apply_norm(lp["ln1"], h, cfg)
        a, _ = L.attention_decode(lp["attn"], a_in, _layer(attn, i), pos,
                                  cfg, rope=False)
        h = h + a
        # cross attention over the precomputed encoder K/V
        x_in = L.apply_norm(lp["lnx"], h, cfg)
        q = einsum("bsd,dhk->bhsk", x_in, lp["xattn"]["wq"])
        out = L._attend(q, cache["cross_k"][i], cache["cross_v"][i],
                        causal=False, window=None)
        h = h + einsum("bhsk,hkd->bsd", out, lp["xattn"]["wo"])
        h = h + L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], h, cfg), cfg)
    h = L.apply_norm(params["ln_f"], h, cfg)
    logits = L.logits_fn(params["embed"], h, cfg)
    return logits, cache
