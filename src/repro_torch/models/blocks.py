"""The transformer block (``repro/models/blocks.py:67-151``): GQA attention
(``gqa_qkv``/``gqa_full``/``gqa_decode`` at ``:30-64``) or MLA, and a
dense FFN or a mixture of experts; the full-sequence forward and the
one-token decode.  The reference's hybrid (SSM) branches are not ported
yet."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .attention import KVCache, attention, decode_attention, kv_cache_update
from .common import apply_rope, dense_init, rms_norm
from .ffn import ffn_apply, ffn_init, moe_apply, moe_init
from .mla import mla_decode, mla_init, mla_prefill

# the families whose layers are the dense block: the text models, and
# musicgen and internvl2 (their frontends are stubs before the same stack)
DENSE_FAMILIES = ("dense", "audio", "vlm")
# ... and the mixture-of-experts family (kimi: GQA; deepseek: MLA)
FAMILIES = DENSE_FAMILIES + ("moe",)


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.family} blocks are not ported yet")


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
    check_family(cfg)
    p: Dict[str, Any] = {
        "ln1": torch.zeros(cfg.d_model, dtype=dtype, device=gen.device),
        "ln2": torch.zeros(cfg.d_model, dtype=dtype, device=gen.device),
    }
    if cfg.attn_kind == "mla":
        p["attn"] = mla_init(gen, cfg.mla_config(), dtype)
    else:
        p["attn"] = gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.resolved_head_dim, dtype)
    if cfg.n_experts:
        p["moe"] = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                            cfg.n_shared, dtype)
    else:
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def _ffn(params: Dict, cfg, h: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on the normed h: (out, the MoE aux or None)."""
    if cfg.n_experts:
        return moe_apply(params["moe"], h, top_k=cfg.top_k,
                         capacity_factor=cfg.moe_capacity,
                         ffn_kind=cfg.ffn_kind)
    return ffn_apply(params["ffn"], h, kind=cfg.ffn_kind), None


def block_apply(params: Dict, cfg, x: torch.Tensor, *,
                impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence block forward -> (y, the layer's MoE aux loss, or None
    for a dense FFN, where the reference's is a zero)."""
    h = rms_norm(x, params["ln1"], impl=impl)
    if cfg.attn_kind == "mla":
        attn_out, _ = mla_prefill(params["attn"], cfg.mla_config(), h,
                                  impl=impl)
    else:
        attn_out = gqa_full(params["attn"], h, n_heads=cfg.n_heads,
                            n_kv_heads=cfg.n_kv_heads,
                            head_dim=cfg.resolved_head_dim,
                            rope_theta=cfg.rope_theta, impl=impl)
    x = x + attn_out
    y, aux = _ffn(params, cfg, rms_norm(x, params["ln2"], impl=impl))
    return x + y, aux


class BlockCache(NamedTuple):
    # a KVCache, or an MLACache for MLA; the reference's ``ssm`` comes
    # with hymba
    kv: Optional[Any] = None


def block_decode(params: Dict, cfg, x: torch.Tensor, cache: BlockCache, *,
                 window: Optional[int] = None
                 ) -> Tuple[torch.Tensor, BlockCache]:
    """One-token block forward against the layer's KV or latent cache; the
    MoE routes the token as the forward does (its aux is dropped, as in
    the reference).  The reference's SSM branch is not ported yet."""
    check_family(cfg)
    h = rms_norm(x, params["ln1"])
    if cfg.attn_kind == "mla":
        attn_out, kv = mla_decode(params["attn"], cfg.mla_config(), h,
                                  cache.kv)
    else:
        attn_out, kv = gqa_decode(params["attn"], h, cache.kv,
                                  n_heads=cfg.n_heads,
                                  n_kv_heads=cfg.n_kv_heads,
                                  head_dim=cfg.resolved_head_dim,
                                  rope_theta=cfg.rope_theta, window=window)
    x = x + attn_out
    y, _ = _ffn(params, cfg, rms_norm(x, params["ln2"]))
    return x + y, BlockCache(kv=kv)
