"""Causal attention: the prefill through the flash-attention op, and the
dense attention, KV cache and one-token decode of the serving loop.

The reference model runs dense attention on symbolic shapes
(``repro/models/attention.py:26-55``, chosen at ``:220-232``); the port's
full-sequence ``attention`` calls the ``repro_torch::flash_attention``
kernel op, which computes the same function: GQA/MQA, softmax in f32,
causal mask ``kv_pos <= q_pos`` with ``q_offset = 0``.  Heads stay
``(B, S, H, hd)`` in the model; the op sees them transposed to
``(B, H, S, hd)`` views, reads them through their strides and writes its
output in the same layout, so no copy is made on either side.

Decode attends one new token to the cache with ``dense_attention``, in
plain PyTorch as the reference's ``decode_attention`` is plain jnp
(``:238-261``).  The cache's length stays a device tensor: positions and
masks are computed on the device, with no host read.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

from ..kernels import ops

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0,
              window: Optional[int] = None,
              softmax_scale: Optional[float] = None,
              impl: Optional[str] = None) -> torch.Tensor:
    """q (B,S,Hq,hd), k/v (B,T,Hkv,hd) -> (B,S,Hq,hd), through the flash
    op: full-sequence prefill only (``q_offset`` 0, no window)."""
    if q_offset != 0 or window is not None:
        raise NotImplementedError(
            "the flash op serves full-sequence prefill attention only "
            "(q_offset=0, no window); decode goes through decode_attention")
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal, softmax_scale, impl)
    return o.transpose(1, 2)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    q_offset: Union[int, torch.Tensor] = 0,
                    window: Optional[int] = None,
                    pad_mask: Optional[torch.Tensor] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q (B,S,Hq,hd), k/v (B,T,Hkv,hd) -> (B,S,Hq,hd), f32 math.

    ``q_offset``: absolute position of q[0] (an int or a device scalar;
    for decode, the cache length - 1).  ``window``: sliding-window size
    (attend to [pos-window+1, pos]).  ``pad_mask``: (B,T), True = valid."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, s, hkv, hq // hkv, hd).to(torch.float32) * scale
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.to(torch.float32))
    q_pos = q_offset + torch.arange(s, device=q.device)[:, None]   # (S,1)
    kv_pos = torch.arange(t, device=q.device)[None, :]              # (1,T)
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kv_pos <= q_pos)
    if window is not None:
        mask = mask & (kv_pos > q_pos - window)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    scores = torch.where(mask, scores, neg)
    if pad_mask is not None:
        scores = torch.where(pad_mask[:, None, None, None, :], scores, neg)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.to(torch.float32))
    return out.reshape(b, s, hq, v.shape[-1]).to(q.dtype)


# -- KV cache -------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, Smax, Hkv, hd)
    v: torch.Tensor
    length: torch.Tensor  # () int32 on the cache's device: tokens valid


def kv_cache_update(cache: KVCache, k_new: torch.Tensor,
                    v_new: torch.Tensor) -> KVCache:
    """Write ``k_new``/``v_new`` (B,s,Hkv,hd) at rows ``cache.length`` ..
    ``+ s`` and return the cache with its length advanced.

    Unlike the reference (``repro/models/attention.py:244``), which
    returns new arrays, this writes into ``cache.k`` and ``cache.v`` in
    place (``index_copy_``), so a step does not copy the cache; only the
    returned ``length`` is a new tensor.  The rows come from the device
    length: nothing is read back to the host."""
    s = k_new.shape[1]
    rows = cache.length.to(torch.int64) + torch.arange(
        s, device=cache.k.device)
    cache.k.index_copy_(1, rows, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, rows, v_new.to(cache.v.dtype))
    return KVCache(cache.k, cache.v, cache.length + s)


def decode_attention(q: torch.Tensor, cache: KVCache, *,
                     window: Optional[int] = None,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """One-token decode: q (B,1,Hq,hd) against the cache, masked by its
    length (a device-side mask)."""
    t = cache.k.shape[1]
    valid = torch.arange(t, device=q.device)[None, :] < cache.length
    return dense_attention(q, cache.k, cache.v, causal=False, window=window,
                           q_offset=cache.length - 1,
                           pad_mask=valid.expand(q.shape[0], t),
                           softmax_scale=softmax_scale)
