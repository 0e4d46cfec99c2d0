"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, SWA. [arXiv:2401.04088; hf]

SWA window 4096 => sub-quadratic decode state; runs the long_500k cell
with a rolling KV cache capped at the window."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,                 # per-expert
    vocab_size=32768,
    head_dim=128,
    n_experts=8,
    top_k=2,
    moe_group_size=1024,
    window=4096,                # sliding-window attention
    mlp_type="glu",
    act="silu",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    head_dim=16,
    n_experts=4,
    top_k=2,
    moe_group_size=16,
    window=16,
    mlp_type="glu",
    act="silu",
    tie_embeddings=False,
    dtype="float32",
)
