"""minicpm-2b [dense]: 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753 — WSD schedule (arch=llama-like). [arXiv:2404.06395; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,              # MHA
    d_ff=5760,
    vocab_size=122753,
    mlp_type="glu",
    act="silu",
    lr_schedule="wsd",          # the MiniCPM warmup-stable-decay schedule
)

SMOKE = ModelConfig(
    name="minicpm-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=72,
    n_heads=6,
    n_kv_heads=6,
    d_ff=180,
    vocab_size=512,
    mlp_type="glu",
    act="silu",
    lr_schedule="wsd",
    dtype="float32",
)
