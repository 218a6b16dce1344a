"""gemma-2b — GeGLU, MQA (kv=1), head_dim=256 [arXiv:2403.08295; hf].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=256000, head_dim=256,
    ffn_kind="geglu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=256, head_dim=32,
    ffn_kind="geglu", tie_embeddings=True, dtype="float32",
)
