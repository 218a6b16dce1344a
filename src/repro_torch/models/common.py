"""Shared building blocks: normalisation, RoPE and initialisers.

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
