"""Multi-head latent attention (DeepSeek-V3 style), the reference's
``repro/models/mla.py:21-120``.

Prefill: expand the compressed KV latent to per-head K and V and run
``dense_attention`` with q·k over ``qk_nope + qk_rope`` columns and v over
``v_dim``, as the reference does (``mla.py:80``; the flash op takes one
head dim for q, k and v, so MLA never reaches it).  Decode: the absorbed
path, which caches only the latent (``r_kv`` per token) and the shared
RoPE key (``qk_rope`` per token) and folds W_UK and W_UV into the query
and the output; K and V are never expanded.  The latent norms go through
the ``rms_norm`` kernel op.  The cache is written out of place
(``index_copy``) at its device-side length, as the port's ``KVCache``
is (``attention.kv_cache_update``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from .attention import NEG_INF, dense_attention
from .common import apply_rope, dense_init, rms_norm


class MLAConfig(NamedTuple):
    d_model: int
    n_heads: int
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128
    r_kv: int = 512
    r_q: int = 1536  # 0 -> full-rank Q projection
    rope_theta: float = 10000.0


def mla_init(gen: torch.Generator, cfg: MLAConfig,
             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    d, h = cfg.d_model, cfg.n_heads
    qd = cfg.qk_nope + cfg.qk_rope
    p = {
        "w_dkv": dense_init(gen, (d, cfg.r_kv), dtype),
        "kv_norm": torch.zeros(cfg.r_kv, dtype=dtype, device=gen.device),
        "w_uk": dense_init(gen, (cfg.r_kv, h, cfg.qk_nope), dtype),
        "w_uv": dense_init(gen, (cfg.r_kv, h, cfg.v_dim), dtype),
        "w_kr": dense_init(gen, (d, cfg.qk_rope), dtype),
        "w_o": dense_init(gen, (h, cfg.v_dim, d), dtype),
    }
    if cfg.r_q:
        p["w_dq"] = dense_init(gen, (d, cfg.r_q), dtype)
        p["q_norm"] = torch.zeros(cfg.r_q, dtype=dtype, device=gen.device)
        p["w_uq"] = dense_init(gen, (cfg.r_q, h, qd), dtype)
    else:
        p["w_q"] = dense_init(gen, (d, h, qd), dtype)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,R) @ w (R,H,W) -> (B,S,H,W)."""
    b, s, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).view(b, s, *w.shape[1:])


def _queries(params: Dict, cfg: MLAConfig, x: torch.Tensor,
             positions: torch.Tensor, impl=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope) with RoPE at positions)."""
    if cfg.r_q:
        cq = rms_norm(x @ params["w_dq"], params["q_norm"], impl=impl)
        q = _heads(cq, params["w_uq"])
    else:
        q = _heads(x, params["w_q"])
    q_rope = apply_rope(q[..., cfg.qk_nope:], positions, cfg.rope_theta)
    return q[..., :cfg.qk_nope], q_rope


def _latent(params: Dict, cfg: MLAConfig, x: torch.Tensor,
            positions: torch.Tensor, impl=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache entries of x: (c_kv (B,S,r_kv), k_rope (B,S,rope))."""
    c_kv = rms_norm(x @ params["w_dkv"], params["kv_norm"], impl=impl)
    k_rope = apply_rope((x @ params["w_kr"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_prefill(params: Dict, cfg: MLAConfig, x: torch.Tensor,
                q_offset: int = 0, impl=None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x (B,S,D) -> (out (B,S,D), (c_kv, k_rope) latent cache entries)."""
    b, s, d = x.shape
    h = cfg.n_heads
    positions = q_offset + torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _queries(params, cfg, x, positions, impl)
    c_kv, k_rope = _latent(params, cfg, x, positions, impl)
    k_nope = _heads(c_kv, params["w_uk"])
    v = _heads(c_kv, params["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h,
                                                        cfg.qk_rope)], dim=-1)
    scale = 1.0 / math.sqrt(cfg.qk_nope + cfg.qk_rope)
    attn = dense_attention(q, k, v, causal=True, q_offset=q_offset,
                           softmax_scale=scale)
    out = attn.reshape(b, s, h * cfg.v_dim) @ \
        params["w_o"].reshape(h * cfg.v_dim, d)
    return out, (c_kv, k_rope)


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, Smax, r_kv)
    k_rope: torch.Tensor  # (B, Smax, qk_rope)
    length: torch.Tensor  # () int32 on the cache's device: tokens valid


def mla_cache_update(cache: MLACache, c_new: torch.Tensor,
                     kr_new: torch.Tensor) -> MLACache:
    """Write the new rows at ``cache.length`` out of place (``index_copy``)
    and return the new cache with its length advanced, as the reference's
    returns new arrays; no host read."""
    s = c_new.shape[1]
    rows = cache.length.to(torch.int64) + torch.arange(
        s, device=cache.c_kv.device)
    return MLACache(
        cache.c_kv.index_copy(1, rows, c_new.to(cache.c_kv.dtype)),
        cache.k_rope.index_copy(1, rows, kr_new.to(cache.k_rope.dtype)),
        cache.length + s)


def mla_decode(params: Dict, cfg: MLAConfig, x: torch.Tensor,
               cache: MLACache) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed decode: x (B,1,D) at position ``cache.length``; scores
    against the latent and the RoPE key in f32, softmax over the valid
    rows, the context taken back through W_UV, as the reference's."""
    b = x.shape[0]
    d = x.shape[-1]
    h = cfg.n_heads
    pos = cache.length.expand(b, 1)
    q_nope, q_rope = _queries(params, cfg, x, pos)
    c_new, kr_new = _latent(params, cfg, x, pos)
    cache = mla_cache_update(cache, c_new, kr_new)
    t = cache.c_kv.shape[1]
    valid = torch.arange(t, device=x.device) < cache.length        # (T,)
    # absorb W_UK into q: (B,1,H,nope) x (r,H,nope) -> (B,1,H,r)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, params["w_uk"])
    c32 = cache.c_kv.to(torch.float32)
    scale = 1.0 / math.sqrt(cfg.qk_nope + cfg.qk_rope)
    scores = (torch.einsum("bshr,btr->bhst", q_lat.to(torch.float32), c32) +
              torch.einsum("bshd,btd->bhst", q_rope.to(torch.float32),
                           cache.k_rope.to(torch.float32))) * scale
    scores = torch.where(valid, scores, torch.full(
        (), NEG_INF, dtype=torch.float32, device=x.device))
    p = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhst,btr->bshr", p, c32)
    attn = torch.einsum("bshr,rhd->bshd", ctx_lat,
                        params["w_uv"].to(torch.float32))
    out = attn.to(x.dtype).reshape(b, 1, h * cfg.v_dim) @ \
        params["w_o"].reshape(h * cfg.v_dim, d)
    return out, cache
