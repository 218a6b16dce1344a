"""Feed-forward: SwiGLU and GeGLU, the dense-family FFNs of the reference
(``repro/models/ffn.py:24-47``), in plain PyTorch as there."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import dense_init


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def geglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
          w2: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu(approximate=True)``: the tanh form."""
    return (F.gelu(x @ w1, approximate="tanh") * (x @ w3)) @ w2


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return {"w1": dense_init(gen, (d_model, d_ff), dtype),
            "w3": dense_init(gen, (d_model, d_ff), dtype),
            "w2": dense_init(gen, (d_ff, d_model), dtype)}


def ffn_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              kind: str = "swiglu") -> torch.Tensor:
    fn = {"swiglu": swiglu, "geglu": geglu}.get(kind)
    if fn is None:
        raise NotImplementedError(f"ffn kind {kind!r} is not ported yet")
    return fn(x, params["w1"], params["w3"], params["w2"])
