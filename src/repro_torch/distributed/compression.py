"""Gradient compression with error feedback for slow inter-pod links.

Port of ``repro/distributed/compression.py``: int8 per-tensor-block
quantization (scale = max|g| per block of 256) applied before the
cross-pod all-reduce, with an error-feedback accumulator so quantization
noise is unbiased over steps (Karimireddy et al., 2019).  Every shape
here is a parameter's, so a captured train step holds no guard for it.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree


class CompressionState(NamedTuple):
    error: Any  # pytree of f32 residuals, laid out as the grads


def init_compression_state(grads_like: Any) -> CompressionState:
    return CompressionState(error=pytree.tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like))


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization; returns ``(q, scales)``:
    ``q`` (blocks, block) int8, rounded half to even as ``jnp.round``."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype: torch.dtype) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def compress_decompress(g: torch.Tensor, err: torch.Tensor, block: int = 256
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round: returns ``(g_hat, new_err)``, with
    ``g_hat + new_err == g + err`` up to f32 rounding."""
    target = g.float() + err
    q, scale = quantize_int8(target, block)
    g_hat = dequantize_int8(q, scale, g.shape, torch.float32)
    new_err = target - g_hat
    return g_hat.to(g.dtype), new_err


def compress_gradients(grads: Any, state: CompressionState,
                       block: int = 256) -> Tuple[Any, CompressionState]:
    """``compress_decompress`` over every leaf, in the reference's blocks:
    the reference stacks a model's layers into one array per weight, so a
    block may span two layers where a layer's weight is not a whole number
    of blocks; such a layer list is stacked for the round."""
    g_hat, new_err = _compress(grads, state.error, block)
    return g_hat, CompressionState(error=new_err)


def _compress(g: Any, err: Any, block: int) -> Tuple[Any, Any]:
    if isinstance(g, torch.Tensor):
        return compress_decompress(g, err, block)
    if isinstance(g, dict):
        out = {k: _compress(g[k], err[k], block) for k in g}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    if not isinstance(g, (list, tuple)):
        raise TypeError(f"gradient leaf of type {type(g).__name__}")
    trees = [pytree.tree_flatten(x) for x in g]
    aligned = all(t.numel() % block == 0 for leaves, _ in trees
                  for t in leaves)
    if aligned or any(spec != trees[0][1] for _, spec in trees) or any(
            [t.shape for t in leaves] != [t.shape for t in trees[0][0]]
            for leaves, _ in trees):
        # blocks never cross an item (or the items are not one stack)
        out = [_compress(x, e, block) for x, e in zip(g, err)]
        return type(g)(o[0] for o in out), type(g)(o[1] for o in out)
    # the reference's stacked layout: one array per weight across the list
    stacked = [torch.stack(col) for col in zip(*(leaves for leaves, _ in
                                                 trees))]
    errs = [torch.stack(col) for col in
            zip(*(pytree.tree_leaves(e) for e in err))]
    out = [compress_decompress(x, e, block) for x, e in zip(stacked, errs)]
    spec = trees[0][1]
    g_hat = type(g)(pytree.tree_unflatten([o[0][i] for o in out], spec)
                    for i in range(len(g)))
    new_err = type(g)(pytree.tree_unflatten([o[1][i] for o in out], spec)
                      for i in range(len(g)))
    return g_hat, new_err
