"""The dense transformer block (``repro/models/blocks.py:89-151``) with its
GQA attention sub-block (``gqa_qkv``/``gqa_full``/``gqa_decode`` at
``:30-64``): the full-sequence forward and the one-token decode."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .attention import KVCache, attention, decode_attention, kv_cache_update
from .common import apply_rope, dense_init, rms_norm
from .ffn import ffn_apply, ffn_init

# the families whose layers are this dense block: the text models, and
# musicgen and internvl2 (their frontends are stubs before the same stack)
DENSE_FAMILIES = ("dense", "audio", "vlm")


def gqa_init(gen: torch.Generator, d_model: int, n_heads: int,
             n_kv_heads: int, head_dim: int,
             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return {
        "wq": dense_init(gen, (d_model, n_heads * head_dim), dtype),
        "wk": dense_init(gen, (d_model, n_kv_heads * head_dim), dtype),
        "wv": dense_init(gen, (d_model, n_kv_heads * head_dim), dtype),
        "wo": dense_init(gen, (n_heads * head_dim, d_model), dtype),
    }


def gqa_qkv(params: Dict[str, torch.Tensor], x: torch.Tensor, n_heads: int,
            n_kv_heads: int, head_dim: int, positions: torch.Tensor,
            rope_theta: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B,S,Hq,hd) and k (B,S,Hkv,hd) with RoPE at ``positions``, and v."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).view(b, s, n_heads, head_dim)
    k = (x @ params["wk"]).view(b, s, n_kv_heads, head_dim)
    v = (x @ params["wv"]).view(b, s, n_kv_heads, head_dim)
    return (apply_rope(q, positions, rope_theta),
            apply_rope(k, positions, rope_theta), v)


def gqa_full(params: Dict[str, torch.Tensor], x: torch.Tensor, *, n_heads,
             n_kv_heads, head_dim, rope_theta, q_offset: int = 0,
             impl: Optional[str] = None) -> torch.Tensor:
    b, s, _ = x.shape
    positions = q_offset + torch.arange(s, device=x.device)[None, :]
    q, k, v = gqa_qkv(params, x, n_heads, n_kv_heads, head_dim, positions,
                      rope_theta)
    out = attention(q, k, v, causal=True, q_offset=q_offset, impl=impl)
    return out.view(b, s, n_heads * head_dim) @ params["wo"]


def gqa_decode(params: Dict[str, torch.Tensor], x: torch.Tensor,
               cache: KVCache, *, n_heads, n_kv_heads, head_dim, rope_theta,
               window: Optional[int] = None
               ) -> Tuple[torch.Tensor, KVCache]:
    """One token x (B,1,D) at position ``cache.length``: its k/v go into
    the cache (in place), its q attends to every valid row."""
    b, s, _ = x.shape  # s == 1
    positions = cache.length.expand(b, s)
    q, k, v = gqa_qkv(params, x, n_heads, n_kv_heads, head_dim, positions,
                      rope_theta)
    cache = kv_cache_update(cache, k, v)
    out = decode_attention(q, cache, window=window)
    return out.reshape(b, s, n_heads * head_dim) @ params["wo"], cache


def block_init(gen: torch.Generator, cfg, dtype: torch.dtype) -> Dict:
    if cfg.family not in DENSE_FAMILIES:
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


class BlockCache(NamedTuple):
    kv: Optional[KVCache] = None   # the reference's ``ssm`` comes with hymba


def block_decode(params: Dict, cfg, x: torch.Tensor, cache: BlockCache, *,
                 window: Optional[int] = None
                 ) -> Tuple[torch.Tensor, BlockCache]:
    """One-token dense block forward against the layer's KV cache.  The
    reference's MLA, SSM and MoE branches are not ported yet."""
    if cfg.family not in DENSE_FAMILIES:
        raise NotImplementedError(
            f"{cfg.family} decode (MLA, SSM or MoE) is not ported yet")
    h = rms_norm(x, params["ln1"])
    attn_out, kv = gqa_decode(params["attn"], h, cache.kv,
                              n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                              head_dim=cfg.resolved_head_dim,
                              rope_theta=cfg.rope_theta, window=window)
    x = x + attn_out
    x = x + ffn_apply(params["ffn"], rms_norm(x, params["ln2"]),
                      kind=cfg.ffn_kind)
    return x, BlockCache(kv=kv)
