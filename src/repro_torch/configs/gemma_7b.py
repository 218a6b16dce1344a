"""gemma-7b — GeGLU, head_dim=256 [arXiv:2403.08295; hf].

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    d_ff=24576, vocab=256000, head_dim=256,
    ffn_kind="geglu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=32,
    ffn_kind="geglu", tie_embeddings=True, dtype="float32",
)
