"""granite-8b — llama-arch code model [arXiv:2405.04324; hf].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152,
    ffn_kind="swiglu", rope_theta=1e4, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=128,
    ffn_kind="swiglu", tie_embeddings=False, dtype="float32",
)
