"""hymba-1.5b — hybrid parallel attn+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention except global layers {first, middle, last};
runs long_500k (sub-quadratic via SSM + SWA).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    ffn_kind="swiglu", window=1024, ssm_state=16, ssm_expand=2,
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=2, d_model=80, n_heads=5, n_kv_heads=1,
    d_ff=128, vocab=128, head_dim=16,
    ffn_kind="swiglu", window=16, ssm_state=4, ssm_expand=2,
    dtype="float32",
)
