"""SSM (Mamba2) and hybrid (Zamba2-style) LM assemblies (the JAX
package's ``models/hybrid.py``).

``ssm`` family: a pure stack of pre-norm Mamba2 blocks (mamba2-130m).
``hybrid`` family: a Mamba2 backbone with ONE shared attention+MLP block
applied after every ``cfg.attn_every`` Mamba layers (Zamba2's shared
block, without the per-use LoRA deltas of the real model, as in the
reference). The shared block's parameters are the same tensors at every
use, so their gradients accumulate across uses.

The reference scans over the stacked layers; the port loops over them,
each block optionally checkpointed (``StepConfig.remat``). Decode is
ported for the ``ssm`` family; the hybrid family's decode needs the
attention KV cache of the serving slice and raises.
"""

from __future__ import annotations

import torch

from . import layers as L
from . import ssd
from .config import ModelConfig
from .params import ParamDef
from .transformer import StepConfig, _layer, _maybe_remat

__all__ = ["cache_shapes", "decode", "hidden", "hybrid_lm_defs",
           "n_shared_uses", "prefill", "ssm_lm_defs"]

_HYBRID_DECODE_TODO = ("hybrid decode needs attention_decode and the KV "
                       "cache, which are not ported yet (ROADMAP.md, 'Still "
                       "to port': the serving slice)")


def _stacked_norm(cfg: ModelConfig, layers: int) -> ParamDef:
    return ParamDef(shape=(layers, cfg.d_model), logical=("layers", "embed_r"),
                    init="ones", dtype=cfg.tdtype)


def ssm_lm_defs(cfg: ModelConfig) -> dict:
    return {
        "embed": L.embedding_defs(cfg),
        "layers": {"ln": _stacked_norm(cfg, cfg.n_layers),
                   "ssd": ssd.ssd_defs(cfg, layers=cfg.n_layers)},
        "ln_f": L.norm_defs(cfg),
    }


def hybrid_lm_defs(cfg: ModelConfig) -> dict:
    return {
        "embed": L.embedding_defs(cfg),
        "layers": {"ln": _stacked_norm(cfg, cfg.n_layers),
                   "ssd": ssd.ssd_defs(cfg, layers=cfg.n_layers)},
        "shared": {
            "ln1": L.norm_defs(cfg),
            "attn": L.attention_defs(cfg),
            "ln2": L.norm_defs(cfg),
            "mlp": L.mlp_defs(cfg),
        },
        "ln_f": L.norm_defs(cfg),
    }


def n_shared_uses(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def _is_pure_ssm(cfg: ModelConfig) -> bool:
    return cfg.family == "ssm" or not cfg.attn_every


def _groups(cfg: ModelConfig) -> list[range]:
    """The layer indices of each group of ``attn_every`` Mamba layers that
    precedes one use of the shared block (the reference's reshape of the
    stacked layers to (uses, attn_every, ...), which must be exact)."""
    uses = n_shared_uses(cfg)
    if uses * cfg.attn_every != cfg.n_layers:
        raise ValueError(f"{cfg.n_layers} layers are not {uses} groups of "
                         f"{cfg.attn_every}")
    return [range(g * cfg.attn_every, (g + 1) * cfg.attn_every)
            for g in range(uses)]


# ---------------------------------------------------------------------------
# Forward (train) and prefill
# ---------------------------------------------------------------------------


def _mamba_block(h: torch.Tensor, lp: dict, cfg: ModelConfig, *,
                 collect_state: bool = False):
    x_in = L.apply_norm(lp["ln"], h, cfg)
    if collect_state:
        y, state = ssd.ssd_forward(lp["ssd"], x_in, cfg, return_state=True)
        return h + y, state
    return h + ssd.ssd_forward(lp["ssd"], x_in, cfg), None


def _shared_block(h: torch.Tensor, sp: dict, cfg: ModelConfig,
                  step: StepConfig, *, collect_kv: bool = False):
    a_in = L.apply_norm(sp["ln1"], h, cfg)
    if collect_kv:
        # prefill: the plain attention, as in the reference, plus the
        # roped K/V for the decode cache
        q = torch.einsum("bsd,dhk->bhsk", a_in, sp["attn"]["wq"])
        k = torch.einsum("bsd,dhk->bhsk", a_in, sp["attn"]["wk"])
        v = torch.einsum("bsd,dhk->bhsk", a_in, sp["attn"]["wv"])
        pos = torch.arange(h.shape[1], device=h.device)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
        out = L._attend(q, k, v, causal=True, window=cfg.window)
        a = torch.einsum("bhsk,hkd->bsd", out, sp["attn"]["wo"])
        kv = (k, v)
    else:
        a = L.attention_full(sp["attn"], a_in, cfg, causal=True,
                             window=cfg.window, use_flash=step.use_flash,
                             block_q=step.flash_block_q,
                             block_k=step.flash_block_k)
        kv = None
    h = h + a
    h = h + L.apply_mlp(sp["mlp"], L.apply_norm(sp["ln2"], h, cfg), cfg)
    return (h, kv) if collect_kv else h


def hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
           step: StepConfig) -> torch.Tensor:
    """Token ids -> final hidden states (B, S, D)."""
    h = L.embed_tokens(params["embed"], tokens, cfg)
    mamba = _maybe_remat(lambda c, lp: _mamba_block(c, lp, cfg)[0], step)
    if _is_pure_ssm(cfg):
        for i in range(cfg.n_layers):
            h = mamba(h, _layer(params["layers"], i))
    else:
        shared = _maybe_remat(
            lambda c, sp: _shared_block(c, sp, cfg, step), step)
        for group in _groups(cfg):
            for i in group:
                h = mamba(h, _layer(params["layers"], i))
            h = shared(h, params["shared"])
    return L.apply_norm(params["ln_f"], h, cfg)


def prefill(params: dict, batch: dict, cfg: ModelConfig,
            step: StepConfig) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also builds the decode cache: per Mamba
    layer the ssm and conv states (stacked on a leading layers axis) and,
    for the hybrid family, per shared-block use the roped K/V with their
    position tags. Returns (last-position logits, cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = L.embed_tokens(params["embed"], tokens, cfg)
    states = []
    if _is_pure_ssm(cfg):
        for i in range(cfg.n_layers):
            h, state = _mamba_block(h, _layer(params["layers"], i), cfg,
                                    collect_state=True)
            states.append(state)
        kvs = []
    else:
        kvs = []
        for group in _groups(cfg):
            for i in group:
                h, state = _mamba_block(h, _layer(params["layers"], i), cfg,
                                        collect_state=True)
                states.append(state)
            h, kv = _shared_block(h, params["shared"], cfg, step,
                                  collect_kv=True)
            kvs.append(kv)
    cache = {"ssm": torch.stack([s["ssm"] for s in states]),
             "conv": torch.stack([s["conv"] for s in states])}
    if kvs:
        pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
        cache["attn"] = {
            "k": torch.stack([k for k, _ in kvs]),
            "v": torch.stack([v for _, v in kvs]),
            "pos": pos.expand(len(kvs), B, S).clone()}
    h = L.apply_norm(params["ln_f"], h, cfg)
    logits = L.logits_fn(params["embed"], h[:, -1:], cfg)
    return logits, cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ModelConfig, batch: int, cache_length: int) -> dict:
    """Shapes and dtypes of the decode cache (``ssm`` family; the hybrid
    family's attention cache belongs to the serving slice)."""
    if not _is_pure_ssm(cfg):
        raise NotImplementedError(_HYBRID_DECODE_TODO)
    shapes = ssd.ssm_cache_shapes(cfg, cfg.n_layers, batch)
    return {"ssm": shapes["ssm"], "conv": shapes["conv"]}


def decode(params: dict, tokens: torch.Tensor, cache: dict, pos,
           cfg: ModelConfig, step: StepConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode of the ``ssm`` family. tokens: (B, 1). Returns
    (logits (B, 1, V), new cache)."""
    if not _is_pure_ssm(cfg):
        raise NotImplementedError(_HYBRID_DECODE_TODO)
    h = L.embed_tokens(params["embed"], tokens, cfg)
    ssm, conv = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        x_in = L.apply_norm(lp["ln"], h, cfg)
        y, lc = ssd.ssd_decode(lp["ssd"], x_in, {"ssm": cache["ssm"][i],
                                                 "conv": cache["conv"][i]},
                               cfg)
        h = h + y
        ssm.append(lc["ssm"])
        conv.append(lc["conv"])
    new_cache = {**cache, "ssm": torch.stack(ssm), "conv": torch.stack(conv)}
    h = L.apply_norm(params["ln_f"], h, cfg)
    logits = L.logits_fn(params["embed"], h, cfg)
    return logits, new_cache
