"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048, 4 codebooks.
EnCodec frontend is a stub: input_specs() provides frame embeddings;
the LM head predicts all 4 codebooks per frame.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048,
    ffn_kind="swiglu", input_mode="embeddings", n_codebooks=4,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=64,
    ffn_kind="swiglu", input_mode="embeddings", n_codebooks=4,
    tie_embeddings=False, dtype="float32",
)
