"""Shared building blocks: normalisation, RoPE, the loss and initialisers.

``rms_norm`` calls the ``repro_torch::rmsnorm`` kernel op where the
reference model calls its unfused ``rms_norm`` (``repro/models/common.py``):
both compute ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in f32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             impl: Optional[str] = None) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps, impl)


# -- RoPE ---------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd//2,)
    angles = positions[..., None].to(torch.float32) * freqs   # (..., S, hd//2)
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- loss ------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid positions; logits (..., V), labels int (...).

    The reference's form (``repro/models/common.py:112``): log-sum-exp in
    f32 around the detached row max, the label logit picked by an
    ``iota == label`` masked reduction."""
    v = logits.shape[-1]
    lg = logits.to(torch.float32)
    m = torch.amax(lg, dim=-1, keepdim=True).detach()
    shifted = lg - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    iota = torch.arange(v, dtype=torch.int32, device=logits.device)
    onehot = iota == labels[..., None].to(torch.int32)
    label_logit = torch.sum(torch.where(onehot, shifted, 0.0), dim=-1)
    ll = label_logit - lse
    if mask is None:
        return -torch.mean(ll)
    mask = mask.to(torch.float32)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# -- initializers --------------------------------------------------------------


def normal_init(gen: torch.Generator, shape: Sequence[int], std: float,
                dtype: torch.dtype) -> torch.Tensor:
    """``std``-scaled normal draws in f32 from ``gen``, cast to ``dtype``."""
    out = torch.randn(tuple(shape), generator=gen, device=gen.device,
                      dtype=torch.float32)
    return (out * std).to(dtype)


def dense_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, in_axis: int = 0,
               scale: float = 1.0) -> torch.Tensor:
    return normal_init(gen, shape, scale / math.sqrt(shape[in_axis]), dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype) -> torch.Tensor:
    return normal_init(gen, shape, 0.02, dtype)
