"""Top-level language model: init / forward / loss / prefill and the
KV-cache decode (dense family).

Layers are unrolled in Python, as the reference does with
``scan_layers=False`` (``repro/models/lm.py:134-143``): the flat graph is
what the dynamic-shape optimizer schedules and plans.  Parameters are a
plain dict of tensors (the reference's pytree layout, with the per-layer
stacks split into a list), so a step ``fn(params, batch)`` takes its
weights as graph inputs, as the reference's steps do.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.api import resolve_device
from .attention import KVCache
from .blocks import BlockCache, block_apply, block_decode, block_init
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


# -- serving: single-token decode over a KV cache ----------------------------


class DecodeState(NamedTuple):
    """The running decode state: one ``BlockCache`` per layer (the
    reference stacks them on a leading layer axis for its scan; the port
    unrolls its layers, so it keeps a list)."""
    caches: List[BlockCache]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Any = None) -> DecodeState:
    """Zeroed K/V caches of ``max_len`` rows per layer and a length of 0,
    on ``device`` (``cuda`` unless given); the KV branch of
    ``repro/models/lm.py:213-242``."""
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family} caches are not ported yet")
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return DecodeState(caches=[
        BlockCache(kv=KVCache(
            k=torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            v=torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            length=torch.zeros((), dtype=torch.int32, device=dev)))
        for _ in range(cfg.n_layers)])


def decode_step(cfg: ModelConfig, params: Dict, state: DecodeState,
                inp: Dict) -> Tuple[torch.Tensor, DecodeState]:
    """One new token ``inp["token"]`` (B,1) against the running cache ->
    (logits (B,1,V), the new state).  Layers unrolled; each layer's cache
    is written in place (``attention.kv_cache_update``).  RMSNorm runs
    its kernel op; decode attention is plain PyTorch, as the reference's
    is plain jnp."""
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"input mode {cfg.input_mode!r} is not ported yet")
    x = F.embedding(inp["token"], params["embed"]).to(cfg.torch_dtype)
    caches = []
    for layer_p, cache in zip(params["layers"], state.caches):
        x, cache = block_decode(layer_p, cfg, x, cache)
        caches.append(cache)
    return _lm_logits(cfg, params, x, None)[:, -1:], DecodeState(caches)
