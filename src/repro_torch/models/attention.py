"""Causal attention: the prefill through the flash-attention op or, under
a sliding window, the reference's dense and blockwise attention; and the
dense attention, KV cache and one-token decode of the serving loop.

The reference model runs dense attention on symbolic shapes and
``blockwise_attention`` on a concrete T > 2048
(``repro/models/attention.py:26-55``, ``:58-217``, chosen at
``:220-232``).  The port's full-sequence ``attention`` calls the
``repro_torch::flash_attention`` kernel op wherever it computes the same
function: GQA/MQA, softmax in f32, causal mask ``kv_pos <= q_pos`` with
``q_offset = 0``, and no window or one the sequence does not reach
(hymba's global layers carry a window of 2**30).  Heads stay
``(B, S, H, hd)`` in the model; the op sees them transposed to
``(B, H, S, hd)`` views, reads them through their strides and writes its
output in the same layout, so no copy is made on either side.  A window
that the sequence reaches takes the reference's route: ``blockwise_attention``
(online softmax over KV blocks, a block-restreaming backward) for a
concrete T past ``BLOCKWISE_THRESHOLD``, else ``dense_attention``; the
route depends only on the window and T, never on a failure.  Neither
flash kernel takes a window mask (the TPU kernel has none).

Decode attends one new token to the cache with ``dense_attention``, in
plain PyTorch as the reference's ``decode_attention`` is plain jnp
(``:238-261``).  The cache's length stays a device tensor: positions and
masks are computed on the device, with no host read.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from ..kernels import ops

NEG_INF = -1e30
# the reference's attention dispatch (repro/models/attention.py:220-232):
# blockwise past this many keys, in blocks of BLOCK_KV
BLOCKWISE_THRESHOLD = 2048
BLOCK_KV = 512


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0,
              window: Optional[int] = None,
              softmax_scale: Optional[float] = None,
              impl: Optional[str] = None) -> torch.Tensor:
    """q (B,S,Hq,hd), k/v (B,T,Hkv,hd) -> (B,S,Hq,hd).

    No window, or a concrete S and T the window covers: the flash op
    (``q_offset`` 0 only; ``impl`` picks its implementation).  Otherwise
    the reference's dispatch: ``blockwise_attention`` for a concrete T >
    BLOCKWISE_THRESHOLD, ``dense_attention`` for the rest, a symbolic T
    included (``isinstance`` leaves no guard on it)."""
    s, t = q.shape[1], k.shape[1]
    concrete = isinstance(s, int) and isinstance(t, int)
    if window is None or (concrete and max(s, t) <= window):
        if q_offset != 0:
            raise NotImplementedError(
                "the flash op serves full-sequence prefill attention only "
                "(q_offset=0); decode goes through decode_attention")
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal, softmax_scale,
                                impl)
        return o.transpose(1, 2)
    if concrete and t > BLOCKWISE_THRESHOLD:
        return blockwise_attention(q, k, v, causal=causal, q_offset=q_offset,
                                   window=window, softmax_scale=softmax_scale)
    return dense_attention(q, k, v, causal=causal, q_offset=q_offset,
                           window=window, softmax_scale=softmax_scale)


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
    g = hq // hkv
    # the reference's einsums "bshgd,bthd->bhgst" and "bhgst,bthd->bshgd"
    # as batched products over (b, h) of contiguous operands: an einsum
    # lays its operands out by which dims are 1, so at b = 1 it hands the
    # product a transposed operand where a plan captured with a symbolic b
    # hands it a contiguous copy, and the two round differently
    qg = (q.reshape(b, s, hkv, g, hd).to(torch.float32) * scale).permute(
        0, 2, 3, 1, 4).reshape(b, hkv, g * s, hd).contiguous()
    kt = k.to(torch.float32).permute(0, 2, 3, 1).contiguous()  # (B,H,hd,T)
    scores = torch.matmul(qg, kt).view(b, hkv, g, s, t)
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
    p = torch.softmax(scores, dim=-1).reshape(b, hkv, g * s, t)
    vh = v.to(torch.float32).permute(0, 2, 1, 3).contiguous()   # (B,H,T,dv)
    out = torch.matmul(p.contiguous(), vh).view(b, hkv, g, s, -1)
    return out.permute(0, 3, 1, 2, 4).contiguous().view(
        b, s, hq, v.shape[-1]).to(q.dtype)


# -- blockwise (flash-style) attention in plain PyTorch ------------------------


def _block_mask(sc: torch.Tensor, kv_pos: torch.Tensor, q_pos: torch.Tensor,
                causal: bool, window: Optional[int],
                mblk: Optional[torch.Tensor]) -> torch.Tensor:
    """The causal, window and pad masks on a score block (b,hkv,g,s,blk)."""
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=sc.device)
    if causal:
        sc = torch.where(kv_pos[None, :] <= q_pos[:, None], sc, neg)
    if window is not None:
        sc = torch.where(kv_pos[None, :] > q_pos[:, None] - window, sc, neg)
    if mblk is not None:
        sc = torch.where(mblk[:, None, None, None, :], sc, neg)
    return sc


def _kv_blocks(k: torch.Tensor, v: torch.Tensor,
               pad_mask: Optional[torch.Tensor], block_kv: int):
    """K/V (and the pad mask) padded to whole blocks of ``block_kv``
    rows; the padding masked out.  Returns k, v, mask, nblk."""
    b, t = k.shape[:2]
    nblk = -(-t // block_kv)
    t_pad = nblk * block_kv
    if t_pad != t:
        k = F.pad(k, (0, 0, 0, 0, 0, t_pad - t))
        v = F.pad(v, (0, 0, 0, 0, 0, t_pad - t))
        if pad_mask is not None:
            pad_mask = F.pad(pad_mask, (0, t_pad - t))
        else:
            pad_mask = (torch.arange(t_pad, device=k.device)[None, :] < t
                        ).expand(b, t_pad)
    return k, v, pad_mask, nblk


class _BlockwiseAttention(torch.autograd.Function):
    """The reference's ``_flash_attention`` custom VJP: an online-softmax
    forward over KV blocks that saves the f32 output and the log-sum-exp,
    and a backward that streams the blocks again; neither pass holds the
    (S, T) scores."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, window, causal, block_kv, scale,
                q_offset):
        b, s, hq, hd = q.shape
        hkv = k.shape[2]
        g = hq // hkv
        qg = q.reshape(b, s, hkv, g, hd).to(torch.float32)
        kb, vb, mb, nblk = _kv_blocks(k, v, pad_mask, block_kv)
        q_pos = q_offset + torch.arange(s, device=q.device)
        m = torch.full((b, hkv, g, s), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, s, hkv, g, v.shape[-1]), dtype=torch.float32,
                          device=q.device)
        for c in range(nblk):
            rows = slice(c * block_kv, (c + 1) * block_kv)
            kblk, vblk = kb[:, rows], vb[:, rows]
            kv_pos = c * block_kv + torch.arange(block_kv, device=q.device)
            sc = torch.einsum("bshgd,bthd->bhgst", qg,
                              kblk.to(torch.float32)) * scale
            sc = _block_mask(sc, kv_pos, q_pos, causal, window,
                             None if mb is None else mb[:, rows])
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            # P rounded to V's dtype, the product accumulated in f32
            pv = torch.einsum("bhgst,bthd->bshgd",
                              p.to(vblk.dtype).to(torch.float32),
                              vblk.to(torch.float32))
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        out = acc / l_safe.permute(0, 3, 1, 2)[..., None]
        lse = m + torch.log(l_safe)
        ctx.save_for_backward(q, k, v, out, lse,
                              *(() if pad_mask is None else (pad_mask,)))
        ctx.args = (window, causal, block_kv, scale, q_offset)
        return out.reshape(b, s, hq, v.shape[-1]).to(q.dtype)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse, *pm = ctx.saved_tensors
        window, causal, block_kv, scale, q_offset = ctx.args
        b, s, hq, hd = q.shape
        t, hkv = k.shape[1], k.shape[2]
        g = hq // hkv
        qg = q.reshape(b, s, hkv, g, hd).to(torch.float32)
        do = d_out.to(torch.float32).reshape(b, s, hkv, g, v.shape[-1])
        kb, vb, mb, nblk = _kv_blocks(k, v, pm[0] if pm else None, block_kv)
        q_pos = q_offset + torch.arange(s, device=q.device)
        delta = torch.einsum("bshgd,bshgd->bhgs", do, out)
        dq = torch.zeros((b, s, hkv, g, hd), dtype=torch.float32,
                         device=q.device)
        dks, dvs = [], []
        for c in range(nblk):
            rows = slice(c * block_kv, (c + 1) * block_kv)
            kblk = kb[:, rows].to(torch.float32)
            vblk = vb[:, rows].to(torch.float32)
            kv_pos = c * block_kv + torch.arange(block_kv, device=q.device)
            sc = torch.einsum("bshgd,bthd->bhgst", qg, kblk) * scale
            sc = _block_mask(sc, kv_pos, q_pos, causal, window,
                             None if mb is None else mb[:, rows])
            p = torch.exp(sc - lse[..., None])
            dvs.append(torch.einsum("bhgst,bshgd->bthd", p, do))
            dp = torch.einsum("bshgd,bthd->bhgst", do, vblk)
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhgst,bthd->bshgd", ds, kblk)
            dks.append(torch.einsum("bhgst,bshgd->bthd", ds, qg))
        dk = torch.cat(dks, dim=1)[:, :t]
        dv = torch.cat(dvs, dim=1)[:, :t]
        return (dq.reshape(b, s, hq, hd).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None, None, None)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0,
                        window: Optional[int] = None,
                        pad_mask: Optional[torch.Tensor] = None,
                        block_kv: int = BLOCK_KV,
                        softmax_scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: q (B,S,Hq,hd), k/v
    (B,T,Hkv,hd) -> (B,S,Hq,hd), the KV blocks walked in a Python loop
    with an online softmax, and a backward that streams them again
    (``_BlockwiseAttention``).  ``window``: attend to [pos-window+1, pos];
    ``pad_mask``: (B,T), True = valid."""
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    return _BlockwiseAttention.apply(q, k, v, pad_mask, window, causal,
                                     block_kv, scale, q_offset)


# -- KV cache -------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, Smax, Hkv, hd)
    v: torch.Tensor
    length: torch.Tensor  # () int32 on the cache's device: tokens valid


def kv_cache_update(cache: KVCache, k_new: torch.Tensor,
                    v_new: torch.Tensor) -> KVCache:
    """Write ``k_new``/``v_new`` (B,s,Hkv,hd) at rows ``cache.length`` ..
    ``+ s`` and return the new cache with its length advanced.

    As the reference's (``repro/models/attention.py:244``), which returns
    new arrays from ``dynamic_update_slice``, the write is out of place
    (``index_copy``): ``cache`` is left as it was, so the step is
    functional and ``optimize`` can capture it.  The rows come from the
    device length: nothing is read back to the host."""
    s = k_new.shape[1]
    rows = cache.length.to(torch.int64) + torch.arange(
        s, device=cache.k.device)
    return KVCache(cache.k.index_copy(1, rows, k_new.to(cache.k.dtype)),
                   cache.v.index_copy(1, rows, v_new.to(cache.v.dtype)),
                   cache.length + s)


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
