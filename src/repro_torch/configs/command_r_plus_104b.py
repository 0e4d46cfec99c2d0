"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    head_dim=128,
    mlp_type="glu",
    act="silu",
    norm="layernorm",           # Cohere uses (bias-free) LayerNorm
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="command-r-plus-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    head_dim=16,
    mlp_type="glu",
    act="silu",
    norm="layernorm",
    tie_embeddings=True,
    dtype="float32",
)
