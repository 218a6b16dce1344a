"""Kernel entry points, registered as PyTorch custom ops.

``repro_torch::flash_attention`` and ``repro_torch::rmsnorm`` are
``torch.library.custom_op``s with fake implementations, so a captured
graph keeps exactly one node per kernel call — the counterpart of the
reference's ``flash_attention`` / ``rmsnorm`` primitives
(``repro/kernels/ops.py:109-128``).

Dispatch rules:

* an explicit ``impl="ref"`` always wins: the plain PyTorch version runs,
  on any device;
* otherwise the tensors' device decides: CPU tensors take the plain
  version, CUDA tensors launch the hand-written kernel.  A CUDA tensor
  never falls back to the plain version: the wrapper launches or raises.

Each op returns its output in ``torch.empty_like`` of its first input, on
every route and in its fake, so a captured graph's strides hold at run
time: the model hands flash attention its ``(B, S, H, hd)`` activations
transposed and gets the output back in that layout.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref as _ref
from .flash_attention import flash_attention_cuda
from .rmsnorm import rmsnorm_cuda

IMPLS = (None, "ref")


def _route(impl: Optional[str], x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ref":
        return "ref"
    if x.device.type == "cuda":
        return "cuda"
    if x.device.type == "cpu":
        return "ref"
    raise ValueError(f"no kernel for device {x.device}")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    softmax_scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """q: (B, Hq, S, hd); k/v: (B, Hkv, T, hd) -> (B, Hq, S, hd)."""
    if _route(impl, q) == "ref":
        return torch.empty_like(q).copy_(_ref.reference_attention(
            q, k, v, causal=causal, softmax_scale=softmax_scale))
    return flash_attention_cuda(q, k, v, causal=causal,
                                softmax_scale=softmax_scale)


@flash_attention.register_fake
def _(q, k, v, causal=True, softmax_scale=None, impl=None):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            impl: Optional[str] = None) -> torch.Tensor:
    """x: (..., d); scale: (d,) -> x's shape and dtype."""
    if _route(impl, x) == "ref":
        return _ref.reference_rmsnorm(x, scale, eps)
    return rmsnorm_cuda(x, scale, eps=eps)


@rmsnorm.register_fake
def _(x, scale, eps=1e-6, impl=None):
    return torch.empty_like(x)
