"""xlstm-1.3b — sLSTM + mLSTM blocks (7:1) [arXiv:2405.04517; unverified].

48L d_model=2048 4H d_ff=0 vocab=50304: 6 groups of 7 mLSTM layers and
one sLSTM, d_inner 4096 (hd 1024), no attention and no FFN.  The name is
the paper's; at these widths ``param_count()`` is 3,526,950,912.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    block_kind="xlstm", slstm_every=8, xlstm_proj_factor=2.0,
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab=128,
    block_kind="xlstm", slstm_every=4, xlstm_proj_factor=2.0,
    dtype="float32",
)
