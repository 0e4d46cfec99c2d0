"""Decoder-only LM assembly, dense GQA (the JAX package's
``models/transformer.py``).

Parameters keep the reference's stacked layout (a leading "layers" axis
on every block weight); the reference scans over it, the port loops
over the layers, each optionally checkpointed (``StepConfig.remat``).
Only the train path of the dense family is ported here: MoE, the VLM
cross-attention stack and the dense prefill/decode raise
``NotImplementedError`` naming their ``ROADMAP.md`` entry (the Mamba2
families live in :mod:`repro_torch.models.hybrid`).
"""

from __future__ import annotations

import dataclasses

import torch

from . import layers as L
from .config import ModelConfig
from .params import ParamDef

__all__ = ["StepConfig", "lm_defs", "lm_hidden", "lm_loss"]

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
                step: StepConfig) -> torch.Tensor:
    """One pre-norm block: attention then MLP, each with a residual."""
    a_in = L.apply_norm(lp["ln1"], h, cfg)
    a = L.attention_full(lp["attn"], a_in, cfg, causal=True,
                         window=cfg.window, use_flash=step.use_flash,
                         block_q=step.flash_block_q,
                         block_k=step.flash_block_k)
    h = h + a
    return h + _ffn(lp, L.apply_norm(lp["ln2"], h, cfg), cfg, step)


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
