"""gemma-2b [dense]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=256000 — GeGLU, head_dim=256, MQA on 2b. [arXiv:2403.08295; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,               # MQA
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    mlp_type="glu",
    act="gelu",                 # GeGLU
)

SMOKE = ModelConfig(
    name="gemma-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    mlp_type="glu",
    act="gelu",
    dtype="float32",
)
