"""Top-level language model: init / forward / loss / prefill and the
KV-cache decode (dense family), in the reference's three input modes
(``repro/models/lm.py:54-311``): ``tokens``; ``embeddings`` (musicgen:
frame embeddings in, an ``n_codebooks``-way head out, logits
``(B, S, K, V)``); ``vlm`` (internvl2: ``vis_tokens`` patch embeddings
before the text tokens, the loss over the text positions only).

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
from .blocks import (DENSE_FAMILIES, BlockCache, block_apply, block_decode,
                     block_init)
from .common import dense_init, embed_init, rms_norm, softmax_cross_entropy


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Any = None) -> Dict[str, Any]:
    """Random weights drawn from a seeded ``torch.Generator`` on ``device``
    (``cuda`` unless given)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = cfg.torch_dtype
    vpad = cfg.padded_vocab
    p: Dict[str, Any] = {}
    if cfg.input_mode in ("tokens", "vlm"):
        p["embed"] = embed_init(gen, (vpad, cfg.d_model), dtype)
    if not cfg.tie_embeddings or cfg.input_mode == "embeddings":
        p["lm_head"] = dense_init(
            gen, (cfg.d_model, max(cfg.n_codebooks, 1) * vpad), dtype)
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


def _embed_inputs(cfg: ModelConfig, params: Dict,
                  batch: Dict) -> torch.Tensor:
    """The first hidden state (B, S, D): token embeddings, frame
    embeddings, or the vision prefix ``vis_embed`` (B, vis_tokens, D)
    followed by the text's token embeddings."""
    dtype = cfg.torch_dtype
    if cfg.input_mode == "tokens":
        return F.embedding(batch["tokens"], params["embed"]).to(dtype)
    if cfg.input_mode == "embeddings":
        return batch["frame_embed"].to(dtype)
    if cfg.input_mode == "vlm":
        txt = F.embedding(batch["tokens"], params["embed"]).to(dtype)
        return torch.cat([batch["vis_embed"].to(dtype), txt], dim=1)
    raise ValueError(cfg.input_mode)


def _lm_logits(cfg: ModelConfig, params: Dict, h: torch.Tensor,
               impl: Optional[str]) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], impl=impl)
    if cfg.n_codebooks:
        b, s, _ = h.shape
        logits = (h @ params["lm_head"].to(h.dtype)).reshape(
            b, s, cfg.n_codebooks, cfg.padded_vocab)
        return _mask_pad_vocab(cfg, logits)
    w = params["embed"].t() \
        if cfg.tie_embeddings and cfg.input_mode != "embeddings" \
        else params["lm_head"]
    return _mask_pad_vocab(cfg, h @ w.to(h.dtype))


def forward(cfg: ModelConfig, params: Dict, batch: Dict,
            impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence logits (B, S, V), or (B, S, K, V) with ``K =
    n_codebooks``; in ``vlm`` mode S counts the vision prefix too.
    ``impl`` picks the kernel ops' implementation (``None``: by device;
    ``"ref"``: plain PyTorch)."""
    x = _embed_inputs(cfg, params, batch)
    for layer_p in params["layers"]:
        x = block_apply(layer_p, cfg, x, impl=impl)
    return _lm_logits(cfg, params, x, impl)


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict,
            impl: Optional[str] = None) -> torch.Tensor:
    """Mean next-token cross entropy against ``batch["labels"]``
    (``repro/models/lm.py:193``; dense models have no auxiliary loss):
    over the text positions only in ``vlm`` mode, and over (B, S, K)
    labels with a codebook head (which takes no mask, as the
    reference's)."""
    logits = forward(cfg, params, batch, impl)
    labels = batch["labels"]
    if cfg.input_mode == "vlm":
        logits = logits[:, -labels.shape[1]:]
    if cfg.n_codebooks:
        return softmax_cross_entropy(logits, labels)
    return softmax_cross_entropy(logits, labels, batch.get("mask"))


def prefill(cfg: ModelConfig, params: Dict, batch: Dict,
            impl: Optional[str] = None) -> torch.Tensor:
    """Forward over the prompt; returns last-position logits (B, V), or
    (B, K, V) with a codebook head."""
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
    if cfg.family not in DENSE_FAMILIES:
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
    """One new token ``inp["token"]`` (B,1), or one frame
    ``inp["frame_embed"]`` (B,1,D) in ``embeddings`` mode, against the
    running cache -> (logits (B,1,V) or (B,1,K,V), the new state).  Layers
    unrolled; each layer's cache is written in place
    (``attention.kv_cache_update``).  RMSNorm runs its kernel op; decode
    attention is plain PyTorch, as the reference's is plain jnp."""
    if cfg.input_mode in ("tokens", "vlm"):
        x = F.embedding(inp["token"], params["embed"]).to(cfg.torch_dtype)
    else:
        x = inp["frame_embed"].to(cfg.torch_dtype)
    caches = []
    for layer_p, cache in zip(params["layers"], state.caches):
        x, cache = block_decode(layer_p, cfg, x, cache)
        caches.append(cache)
    return _lm_logits(cfg, params, x, None)[:, -1:], DecodeState(caches)
