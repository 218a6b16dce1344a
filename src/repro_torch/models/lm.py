"""Top-level language model: init / forward / loss / prefill (dense family).

Layers are unrolled in Python, as the reference does with
``scan_layers=False`` (``repro/models/lm.py:134-143``): the flat graph is
what the dynamic-shape optimizer schedules and plans.  Parameters are a
plain dict of tensors (the reference's pytree layout, with the per-layer
stacks split into a list), so a step ``fn(params, batch)`` takes its
weights as graph inputs, as the reference's steps do.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.api import resolve_device
from .blocks import block_apply, block_init
from .common import dense_init, embed_init, rms_norm, softmax_cross_entropy


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Any = None) -> Dict[str, Any]:
    """Random weights drawn from a seeded ``torch.Generator`` on ``device``
    (``cuda`` unless given)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = cfg.torch_dtype
    p: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype)
    p["final_norm"] = torch.zeros(cfg.d_model, dtype=dtype, device=dev)
    p["layers"] = [block_init(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    return p


def _mask_pad_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Pad-vocab columns (table padded to a tile boundary) never win."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    col = torch.arange(cfg.padded_vocab, device=logits.device)
    return torch.where(col < cfg.vocab, logits,
                       torch.full((), -1e30, dtype=logits.dtype,
                                  device=logits.device))


def _lm_logits(cfg: ModelConfig, params: Dict, h: torch.Tensor,
               impl: Optional[str]) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], impl=impl)
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return _mask_pad_vocab(cfg, h @ w.to(h.dtype))


def forward(cfg: ModelConfig, params: Dict, batch: Dict,
            impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence logits (B, S, V).  ``impl`` picks the kernel ops'
    implementation (``None``: by device; ``"ref"``: plain PyTorch)."""
    x = F.embedding(batch["tokens"], params["embed"]).to(cfg.torch_dtype)
    for layer_p in params["layers"]:
        x = block_apply(layer_p, cfg, x, impl=impl)
    return _lm_logits(cfg, params, x, impl)


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict,
            impl: Optional[str] = None) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (``repro/models/lm.py:193``; dense models have no
    auxiliary loss)."""
    logits = forward(cfg, params, batch, impl)
    return softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))


def prefill(cfg: ModelConfig, params: Dict, batch: Dict,
            impl: Optional[str] = None) -> torch.Tensor:
    """Forward over the prompt; returns last-position logits (B, V)."""
    return forward(cfg, params, batch, impl)[:, -1]
