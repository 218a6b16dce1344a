"""Plain PyTorch versions of the hand-written kernels.

They compute the same functions as ``repro/kernels/ref.py`` (the allclose
ground truth of the reference's Pallas kernels).  The kernel ops take them
for CPU tensors and for an explicit ``impl="ref"``; ``chip_smoke.py``
holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, S, hd); k/v: (B, Hkv, T, hd).  Dense softmax attention,
    f32 math, causal mask aligned top-left (``kv_pos <= q_pos``)."""
    b, hq, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, hkv, g, s, hd).float() * scale
    sc = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float())
    if causal:
        mask = torch.arange(t, device=q.device)[None, :] <= \
            torch.arange(s, device=q.device)[:, None]
        sc = torch.where(mask, sc, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.float())
    return o.reshape(b, hq, s, hd).to(q.dtype)


def reference_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)
