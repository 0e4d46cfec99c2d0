"""Model and workload configuration (the JAX package's ``models/config.py``).

``ModelConfig`` keeps every field and property of the reference, so the
ten configuration modules under :mod:`repro_torch.configs` are the same
data; the working dtype is a ``torch.dtype`` (:attr:`ModelConfig.tdtype`).
The workload shapes are the four assigned input-shape cells.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["DECODE_32K", "LONG_500K", "PREFILL_32K", "SHAPES", "TRAIN_4K",
           "ModelConfig", "WorkloadShape", "cache_len",
           "cell_is_applicable", "input_specs"]


def _round_up(x: int, mult: int) -> int:
    return x + (-x) % mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | encdec | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    mlp_type: str = "glu"           # glu | plain | none
    act: str = "silu"               # silu (SwiGLU) | gelu (GeGLU / plain)
    norm: str = "rmsnorm"           # rmsnorm | layernorm (no bias)
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024      # tokens per dispatch group
    # --- attention variants ---
    window: Optional[int] = None    # sliding-window attention (Mixtral)
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    n_frames: int = 1500            # stub conv-frontend output length
    d_enc: int = 0                  # encoder width (= d_model for whisper)
    # --- vlm (llama-3.2-vision) ---
    cross_attn_every: int = 0       # every Nth layer is cross-attention
    n_image_tokens: int = 0         # stub patch-embedding count
    # --- ssm / hybrid (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    attn_every: int = 0             # zamba2: shared attn block interval
    # --- training ---
    lr_schedule: str = "cosine"     # cosine | wsd (MiniCPM)

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to 256 (logits for rows >= vocab_size are masked
        in the loss)."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def tdtype(self) -> torch.dtype:
        """The working dtype of weights and activations."""
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def supports_long_context(self) -> bool:
        """True iff decode state is sub-quadratic in context (SSM/hybrid or
        sliding-window attention). Pure full-attention archs skip long_500k."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    @property
    def has_decoder(self) -> bool:
        return True

    def n_params(self) -> int:
        """Parameter count of the family's definition tree."""
        from . import api  # local import to avoid a cycle
        from .params import n_params as _np
        return _np(api.param_defs(self))

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k of n_experts count)."""
        if self.n_experts == 0:
            return self.n_params()
        total = self.n_params()
        expert_p = 3 * self.d_model * self.d_ff * self.n_experts * self.n_layers
        active_p = 3 * self.d_model * self.d_ff * self.top_k * self.n_layers
        return total - expert_p + active_p


@dataclasses.dataclass(frozen=True)
class WorkloadShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = WorkloadShape("train_4k", 4096, 256, "train")
PREFILL_32K = WorkloadShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = WorkloadShape("decode_32k", 32768, 128, "decode")
LONG_500K = WorkloadShape("long_500k", 524288, 1, "decode")

SHAPES: dict[str, WorkloadShape] = {s.name: s for s in
                                    (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                     LONG_500K)}


def cell_is_applicable(cfg: ModelConfig, shape: WorkloadShape) -> bool:
    """long_500k only runs for sub-quadratic archs (assignment rule)."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


def cache_len(cfg: ModelConfig, shape: WorkloadShape) -> int:
    """KV-cache length for a decode cell: sliding-window archs cap the cache
    at the window (that is the point of SWA)."""
    if cfg.window is not None:
        return min(shape.seq_len, cfg.window)
    return shape.seq_len


# ---------------------------------------------------------------------------
# Input stand-ins (no allocation)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: WorkloadShape) -> dict:
    """Shape and dtype of every model input of this cell.

    train:   {tokens (B,S), [frames|image_embeds]}
    prefill: {tokens (B,S), [frames|image_embeds]}
    decode:  {tokens (B,1), [frames|image_embeds]}

    Tokens are int64 (torch's index dtype) where the reference's are
    int32."""
    from .params import ShapeDtype
    B, S = shape.global_batch, shape.seq_len
    out: dict = {"tokens": ShapeDtype(
        torch.Size((B, S if shape.kind in ("train", "prefill") else 1)),
        torch.int64)}
    if cfg.family == "encdec":
        out["frames"] = ShapeDtype(torch.Size((B, cfg.n_frames, cfg.d_enc)),
                                   cfg.tdtype)
    if cfg.family == "vlm":
        out["image_embeds"] = ShapeDtype(
            torch.Size((B, cfg.n_image_tokens, cfg.d_model)), cfg.tdtype)
    return out
