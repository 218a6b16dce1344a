"""Causal attention for the prefill path, through the flash-attention op.

The reference model runs dense attention on symbolic shapes
(``repro/models/attention.py:26-55``, chosen at ``:220-232``); the port
calls the ``repro_torch::flash_attention`` kernel op, which computes the
same function: GQA/MQA, softmax in f32, causal mask ``kv_pos <= q_pos``
with ``q_offset = 0``.  Heads stay ``(B, S, H, hd)`` in the model; the op
sees them transposed to ``(B, H, S, hd)`` views, reads them through their
strides and writes its output in the same layout, so no copy is made on
either side.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0,
              window: Optional[int] = None,
              softmax_scale: Optional[float] = None,
              impl: Optional[str] = None) -> torch.Tensor:
    """q (B,S,Hq,hd), k/v (B,T,Hkv,hd) -> (B,S,Hq,hd)."""
    if q_offset != 0 or window is not None:
        raise NotImplementedError(
            "only full-sequence prefill attention (q_offset=0, no window) "
            "is ported so far")
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal, softmax_scale, impl)
    return o.transpose(1, 2)
