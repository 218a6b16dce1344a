"""starcoder2-7b — GQA + RoPE code model [arXiv:2402.19173; hf].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152,
    ffn_kind="swiglu", rope_theta=1e5, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense",
    n_layers=2, d_model=72, n_heads=6, n_kv_heads=2,
    d_ff=128, vocab=128,
    ffn_kind="swiglu", tie_embeddings=False, dtype="float32",
)
