"""Feed-forward: SwiGLU (the dense-family FFN of the reference)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import dense_init


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return {"w1": dense_init(gen, (d_model, d_ff), dtype),
            "w3": dense_init(gen, (d_model, d_ff), dtype),
            "w2": dense_init(gen, (d_ff, d_model), dtype)}


def ffn_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              kind: str = "swiglu") -> torch.Tensor:
    if kind != "swiglu":
        raise NotImplementedError(f"ffn kind {kind!r} is not ported yet")
    return swiglu(x, params["w1"], params["w3"], params["w2"])
