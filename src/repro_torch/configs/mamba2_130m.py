"""mamba2-130m [ssm]: 24L d_model=768 (attn-free) d_ff=0 vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]

Attention-free: O(1) decode state => runs the long_500k cell."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,                 # unused (attn-free); kept for bookkeeping
    n_kv_heads=12,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    mlp_type="none",
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=8,
    mlp_type="none",
    dtype="float32",
)
