"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Vision tower is stubbed: ``input_specs`` provides pre-projected patch
embeddings (B, 1600, 4096). Every 5th layer is a cross-attention layer."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    cross_attn_every=5,
    n_image_tokens=1600,
    mlp_type="glu",
    act="silu",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke",
    family="vlm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    cross_attn_every=2,
    n_image_tokens=16,
    mlp_type="glu",
    act="silu",
    tie_embeddings=False,
    dtype="float32",
)
