"""The dense transformer block (``repro/models/blocks.py:89-117``) with its
GQA attention sub-block (``gqa_full`` at ``:42-49``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .attention import attention
from .common import apply_rope, dense_init, rms_norm
from .ffn import ffn_apply, ffn_init


def gqa_init(gen: torch.Generator, d_model: int, n_heads: int,
             n_kv_heads: int, head_dim: int,
             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return {
        "wq": dense_init(gen, (d_model, n_heads * head_dim), dtype),
        "wk": dense_init(gen, (d_model, n_kv_heads * head_dim), dtype),
        "wv": dense_init(gen, (d_model, n_kv_heads * head_dim), dtype),
        "wo": dense_init(gen, (n_heads * head_dim, d_model), dtype),
    }


def gqa_full(params: Dict[str, torch.Tensor], x: torch.Tensor, *, n_heads,
             n_kv_heads, head_dim, rope_theta, q_offset: int = 0,
             impl: Optional[str] = None) -> torch.Tensor:
    b, s, _ = x.shape
    positions = q_offset + torch.arange(s, device=x.device)[None, :]
    q = (x @ params["wq"]).view(b, s, n_heads, head_dim)
    k = (x @ params["wk"]).view(b, s, n_kv_heads, head_dim)
    v = (x @ params["wv"]).view(b, s, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    out = attention(q, k, v, causal=True, q_offset=q_offset, impl=impl)
    return out.view(b, s, n_heads * head_dim) @ params["wo"]


def block_init(gen: torch.Generator, cfg, dtype: torch.dtype) -> Dict:
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family} blocks are not ported yet")
    return {
        "ln1": torch.zeros(cfg.d_model, dtype=dtype, device=gen.device),
        "ln2": torch.zeros(cfg.d_model, dtype=dtype, device=gen.device),
        "attn": gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim, dtype),
        "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def block_apply(params: Dict, cfg, x: torch.Tensor, *,
                impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence dense block forward."""
    h = rms_norm(x, params["ln1"], impl=impl)
    x = x + gqa_full(params["attn"], h, n_heads=cfg.n_heads,
                     n_kv_heads=cfg.n_kv_heads,
                     head_dim=cfg.resolved_head_dim,
                     rope_theta=cfg.rope_theta, impl=impl)
    return x + ffn_apply(params["ffn"], rms_norm(x, params["ln2"], impl=impl),
                         kind=cfg.ffn_kind)
