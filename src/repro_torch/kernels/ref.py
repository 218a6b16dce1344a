"""Plain PyTorch versions of the hand-written kernels, and their gradients.

They compute the same functions as ``repro/kernels/ref.py`` (the allclose
ground truth of the reference's Pallas kernels).  The kernel ops take them
for CPU tensors and for an explicit ``impl="ref"``; ``chip_smoke.py``
holds each CUDA kernel against them on the card.

The math runs in float32, or in float64 for float64 inputs (so
``torch.autograd.gradcheck`` can hold the gradients to its tolerances).

The ``*_backward`` functions are the gradients of those functions, written
out in plain PyTorch: the kernel ops' autograd (``ops.py``) calls them, so
a captured train step records the backward as ordinary aten nodes.  They
match the reference train step, which differentiates its dense attention
and unfused ``rms_norm`` (``repro/models/common.py:51``) with autodiff; the
reference has no backward kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The math dtype: float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped, scaled q (B, Hkv, G, S, hd) and the softmax probabilities
    (B, Hkv, G, S, T) of dense causal GQA attention."""
    b, hq, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    acc = _acc(q.dtype)
    qg = q.reshape(b, hkv, hq // hkv, s, hd).to(acc) * scale
    sc = torch.einsum("bhgsd,bhtd->bhgst", qg, k.to(acc))
    if causal:
        mask = torch.arange(t, device=q.device)[None, :] <= \
            torch.arange(s, device=q.device)[:, None]
        sc = torch.where(mask, sc, torch.full((), NEG_INF, dtype=acc,
                                              device=q.device))
    return qg, torch.softmax(sc, dim=-1)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, S, hd); k/v: (B, Hkv, T, hd).  Dense softmax attention,
    f32 math, causal mask aligned top-left (``kv_pos <= q_pos``)."""
    b, hq, s, hd = q.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    _, p = _scores(q, k, causal, scale)
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(p.dtype))
    return o.reshape(b, hq, s, hd).to(q.dtype)


def reference_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
        *, causal: bool = True, softmax_scale: Optional[float] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`reference_attention` for the output gradient
    ``do`` (B, Hq, S, hd); the probabilities are recomputed from q and k."""
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qg, p = _scores(q, k, causal, scale)
    kf, vf = k.to(p.dtype), v.to(p.dtype)
    dog = do.reshape(b, hkv, hq // hkv, s, hd).to(p.dtype)
    dv = torch.einsum("bhgst,bhgsd->bhtd", p, dog)
    dp = torch.einsum("bhgsd,bhtd->bhgst", dog, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhgst,bhtd->bhgsd", ds, kf) * scale
    dk = torch.einsum("bhgst,bhgsd->bhtd", ds, qg)
    return (dq.reshape(b, hq, s, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def reference_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    acc = _acc(x.dtype)
    xf = x.to(acc)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.to(acc))).to(x.dtype)


def reference_rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor,
                               dy: torch.Tensor, eps: float = 1e-6
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of :func:`reference_rmsnorm` for the output gradient
    ``dy``: with r = rsqrt(mean(x²) + eps) and g = dy·(1 + scale),
    dx = r·g − r³·x·mean(g·x) and dscale = Σ_rows dy·x·r."""
    acc = _acc(x.dtype)
    xf, dyf = x.to(acc), dy.to(acc)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    g = dyf * (1.0 + scale.to(acc))
    dx = r * g - xf * (r * r * r) * torch.mean(g * xf, dim=-1, keepdim=True)
    dscale = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


# ---------------------------------------------------------------------------
# Value-dependent bounded ops (``kernels.ops``): the tight run versions and
# the reference's padded-to-bound oracles.
#
# The ``tight_*`` functions are what the ops run: the payload holds only
# its ``count`` valid rows, so the tensors downstream of an introducer are
# tight on the device too.  ``pad_to`` (>= the input's length, or -1) pads
# the input with zeros to that length first, as a transient: the extent
# the reference's padded input has there when the op is chained after
# another introducer.  The count is computed over the padded input, and
# the payload keeps at most the input's own length of rows (the bounded
# dim's cap in a chain, which ``BindDim`` clamps to as well).
#
# The ``padded_*`` functions are the torch counterparts of the reference's
# oracles (``repro/kernels/ref.py:46-81``): every payload keeps the input's
# shape, the valid prefix holds the result and the tail is zeros.  The
# tests hold the tight ops against them.
# ---------------------------------------------------------------------------


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``n`` rows (itself if not
    shorter)."""
    if n <= x.shape[0]:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


def _count(n: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32, device=device)


def tight_nonzero(x: torch.Tensor, pad_to: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 indices of the nonzero entries of 1-D ``x``, and their count
    (zero padding adds none, so ``pad_to`` changes nothing)."""
    idx = torch.nonzero(x).reshape(-1).to(torch.int32)
    return idx, _count(idx.shape[0], x.device)


def tight_masked_select(x: torch.Tensor, mask: torch.Tensor,
                        pad_to: int = -1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows of ``x`` (leading axis) where 1-D ``mask`` holds, in order, and
    their count (padding rows are unselected, so ``pad_to`` changes
    nothing)."""
    rows = x[mask]
    return rows, _count(rows.shape[0], x.device)


def tight_topk_dynamic(x: torch.Tensor, k: torch.Tensor, pad_to: int = -1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The largest ``k`` values of 1-D ``x`` (``k`` an int32 scalar tensor),
    descending, and ``clip(k, 0, len)`` over the padded input."""
    xp = _pad_rows(x, pad_to)
    vals = torch.sort(xp, descending=True).values
    count = int(k.clamp(0, xp.shape[0]))
    return vals[:min(count, x.shape[0])], _count(count, x.device)


def tight_unique_bounded(x: torch.Tensor, pad_to: int = -1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sorted distinct values of 1-D ``x`` (zeros padded to ``pad_to``
    count as values), and their count."""
    uniq = torch.unique(_pad_rows(x, pad_to), sorted=True)
    return uniq[:x.shape[0]], _count(uniq.shape[0], x.device)


def _keep_prefix(x: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Zero out rows at index >= count (rows = leading axis)."""
    keep = torch.arange(x.shape[0], device=x.device) < count
    keep = keep.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return torch.where(keep, x, torch.zeros_like(x))


def padded_nonzero(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of nonzero entries of 1-D ``x``, zero-padded to len(x)."""
    nz = x != 0
    idx = torch.nonzero(nz).reshape(-1).to(torch.int32)
    out = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    out[:idx.shape[0]] = idx
    return out, nz.sum(dtype=torch.int32)


def padded_masked_select(x: torch.Tensor, mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows of ``x`` where 1-D ``mask`` holds, compacted to the front."""
    count = mask.sum(dtype=torch.int32)
    perm = torch.argsort((~mask).to(torch.int8), stable=True)
    return _keep_prefix(x[perm], count), count


def padded_topk_dynamic(x: torch.Tensor, k: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest ``k`` values of 1-D ``x`` (k data-dependent), descending."""
    count = k.to(torch.int32).clamp(0, x.shape[0])
    return _keep_prefix(torch.sort(x, descending=True).values, count), count


def padded_unique_bounded(x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted distinct values of 1-D ``x``, zero-padded to len(x)."""
    s = torch.sort(x).values
    isnew = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                       s[1:] != s[:-1]])
    count = isnew.sum(dtype=torch.int32)
    perm = torch.argsort((~isnew).to(torch.int8), stable=True)
    return _keep_prefix(s[perm], count), count
