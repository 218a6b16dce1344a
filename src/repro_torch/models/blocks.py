"""The transformer block (``repro/models/blocks.py:67-151``): GQA attention
(``gqa_qkv``/``gqa_full``/``gqa_decode`` at ``:30-64``, with an optional
sliding window) or MLA, and a dense FFN or a mixture of experts; in the
hybrid family (hymba) a selective SSM on its own norm runs beside the
attention and the two are averaged; the full-sequence forward and the
one-token decode."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .attention import KVCache, attention, decode_attention, kv_cache_update
from .common import apply_rope, dense_init, rms_norm
from .ffn import ffn_apply, ffn_init, moe_apply, moe_init
from .mla import mla_decode, mla_init, mla_prefill
from .ssm import SSMCache, ssm_apply, ssm_decode_step, ssm_init

# the families whose layers are the dense block: the text models, and
# musicgen and internvl2 (their frontends are stubs before the same stack)
DENSE_FAMILIES = ("dense", "audio", "vlm")
# ... the mixture-of-experts family (kimi: GQA; deepseek: MLA) and the
# hybrid family (hymba: attention and an SSM side by side)
FAMILIES = DENSE_FAMILIES + ("moe", "hybrid")


def check_family(cfg) -> None:
    """Refuses a config the port cannot run: a transformer block of a
    family not in FAMILIES, or a block kind other than ``transformer`` and
    ``xlstm`` (whose layers are ``models/xlstm.py``'s, not this block)."""
    ported = cfg.family in FAMILIES if cfg.block_kind == "transformer" \
        else cfg.block_kind == "xlstm"
    if not ported:
        raise NotImplementedError(
            f"{cfg.family} {cfg.block_kind} blocks are not ported yet")


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
             window: Optional[int] = None,
             impl: Optional[str] = None) -> torch.Tensor:
    b, s, _ = x.shape
    positions = q_offset + torch.arange(s, device=x.device)[None, :]
    q, k, v = gqa_qkv(params, x, n_heads, n_kv_heads, head_dim, positions,
                      rope_theta)
    out = attention(q, k, v, causal=True, q_offset=q_offset, window=window,
                    impl=impl)
    return out.view(b, s, n_heads * head_dim) @ params["wo"]


def gqa_decode(params: Dict[str, torch.Tensor], x: torch.Tensor,
               cache: KVCache, *, n_heads, n_kv_heads, head_dim, rope_theta,
               window: Optional[int] = None
               ) -> Tuple[torch.Tensor, KVCache]:
    """One token x (B,1,D) at position ``cache.length``: its k/v go into
    a new cache (``kv_cache_update``), its q attends to every valid row."""
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
    if cfg.family == "hybrid":
        p["ssm"] = ssm_init(gen, cfg.ssm_config(), dtype)
        p["ln_ssm"] = torch.zeros(cfg.d_model, dtype=dtype, device=gen.device)
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
                window: Optional[int] = None, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence block forward -> (y, the layer's MoE aux loss, or None
    for a dense FFN, where the reference's is a zero).  ``window``: the
    layer's sliding window (GQA), as ``lm.layer_windows`` gives it."""
    h = rms_norm(x, params["ln1"], impl=impl)
    if cfg.attn_kind == "mla":
        attn_out, _ = mla_prefill(params["attn"], cfg.mla_config(), h,
                                  impl=impl)
    else:
        attn_out = gqa_full(params["attn"], h, n_heads=cfg.n_heads,
                            n_kv_heads=cfg.n_kv_heads,
                            head_dim=cfg.resolved_head_dim,
                            rope_theta=cfg.rope_theta, window=window,
                            impl=impl)
    if cfg.family == "hybrid":  # parallel attn + SSM heads (hymba)
        ssm_out = ssm_apply(params["ssm"], cfg.ssm_config(),
                            rms_norm(x, params["ln_ssm"], impl=impl))
        attn_out = 0.5 * (attn_out + ssm_out)
    x = x + attn_out
    y, aux = _ffn(params, cfg, rms_norm(x, params["ln2"], impl=impl))
    return x + y, aux


class BlockCache(NamedTuple):
    kv: Optional[Any] = None         # a KVCache, or an MLACache for MLA
    ssm: Optional[SSMCache] = None   # the hybrid family's SSM state


def block_decode(params: Dict, cfg, x: torch.Tensor, cache: BlockCache, *,
                 window: Optional[int] = None
                 ) -> Tuple[torch.Tensor, BlockCache]:
    """One-token block forward against the layer's KV or latent cache (and
    in the hybrid family its SSM state); the MoE routes the token as the
    forward does (its aux is dropped, as in the reference)."""
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
    new_ssm = cache.ssm
    if cfg.family == "hybrid":
        ssm_out, new_ssm = ssm_decode_step(params["ssm"], cfg.ssm_config(),
                                           rms_norm(x, params["ln_ssm"]),
                                           cache.ssm)
        attn_out = 0.5 * (attn_out + ssm_out)
    x = x + attn_out
    y, _ = _ffn(params, cfg, rms_norm(x, params["ln2"]))
    return x + y, BlockCache(kv=kv, ssm=new_ssm)
