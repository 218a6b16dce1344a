"""kimi-k2-1t-a32b — trillion-param MoE 384e top-8 [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert) vocab=163840.
As in the reference's config, the attention is GQA with 8 KV heads (the
public K2 report uses MLA); head dim 7168 / 64 = 112.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, n_shared=1, ffn_kind="swiglu",
    tie_embeddings=False, optimizer_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="kimi-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab=128,
    n_experts=8, top_k=2, n_shared=1, ffn_kind="swiglu",
    tie_embeddings=False, dtype="float32",
)
