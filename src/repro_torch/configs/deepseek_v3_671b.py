"""deepseek-v3-671b — MLA + MoE 256e top-8 (+1 shared) [arXiv:2412.19437; hf].

61L d_model=7168 128H d_ff=2048(expert) vocab=129280; MLA r_kv=512 r_q=1536,
qk_nope/v=128, qk_rope=64.  The multi-token-prediction head is omitted, as
in the reference; optimizer states in bf16 for the trillion-class configs.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280,
    attn_kind="mla", qk_nope=128, qk_rope=64, v_dim=128, r_kv=512, r_q=1536,
    n_experts=256, top_k=8, n_shared=1, ffn_kind="swiglu",
    tie_embeddings=False, optimizer_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=128,
    attn_kind="mla", qk_nope=16, qk_rope=8, v_dim=16, r_kv=24, r_q=32,
    n_experts=8, top_k=2, n_shared=1, ffn_kind="swiglu",
    tie_embeddings=False, dtype="float32",
)
