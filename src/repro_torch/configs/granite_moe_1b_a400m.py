"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Small d_ff + many experts => small MoE dispatch groups (DESIGN.md §5)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,                   # per-expert
    vocab_size=49155,
    n_experts=32,
    top_k=8,
    moe_group_size=256,
    mlp_type="glu",
    act="silu",
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab_size=512,
    n_experts=4,
    top_k=2,
    moe_group_size=16,
    mlp_type="glu",
    act="silu",
    dtype="float32",
)
