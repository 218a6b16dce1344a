"""internvl2-2b — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The ViT frontend is
a stub per the assignment: input_specs() provides precomputed patch
embeddings; loss is over text positions.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553,
    ffn_kind="swiglu", input_mode="vlm", vis_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=128,
    ffn_kind="swiglu", input_mode="vlm", vis_tokens=8,
    dtype="float32",
)
