"""whisper-base [audio]: 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865 —
enc-dec, conv frontend (stub). [arXiv:2212.04356; unverified]

The conv frontend is stubbed: ``input_specs`` provides precomputed frame
embeddings (B, 1500, 512). Positional encodings are sinusoidal on both
sides (DESIGN.md §4)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,                 # decoder layers
    n_enc_layers=6,
    d_model=512,
    d_enc=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    n_frames=1500,
    mlp_type="plain",
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-base-smoke",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    d_enc=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    n_frames=24,
    mlp_type="plain",
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    dtype="float32",
)
