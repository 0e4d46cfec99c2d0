"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240,
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks.
[arXiv:2411.15242; hf]

One shared attention+MLP block applied after every 6th Mamba2 layer (the
per-use LoRA deltas of the real model are omitted; DESIGN.md §4). The
shared attention uses a 4096 sliding window so the hybrid decode state is
O(1) in context => runs the long_500k cell."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,              # MHA in the shared block
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    attn_every=6,
    window=4096,
    mlp_type="glu",
    act="gelu",
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=8,
    attn_every=2,
    window=16,
    mlp_type="glu",
    act="gelu",
    dtype="float32",
)
