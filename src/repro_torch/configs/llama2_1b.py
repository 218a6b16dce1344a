"""llama2-1b — the paper's evaluation model: Llama-2-7b with n_layers=4.

32H d_model=4096 kv=32 d_ff=11008 vocab=32000 (Table 1 / §3 of the paper).
SMOKE is the width-reduced version used for CPU-runnable tests.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-1b", family="dense",
    n_layers=4, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=32000,
    ffn_kind="swiglu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="llama2-smoke", family="dense",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=344, vocab=512,
    ffn_kind="swiglu", tie_embeddings=False, dtype="float32",
)
