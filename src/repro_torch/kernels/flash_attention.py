"""Hand-written CUDA flash-attention forward (causal GQA, online softmax).

Port of the TPU kernel ``src/repro/kernels/flash_attention.py``
(``_flash_kernel``, wrapper ``flash_attention``, ``pallas_call`` at line
108).  The kernel source is ``repro_torch/csrc/flash_attention.cu``; its
header says what bounds it on an H100 (bytes up to S ~ 1200, operations
beyond) and how the design
maps the TPU's sequential kv grid axis onto a loop inside one CTA.

``flash_attention_cuda`` is the launch wrapper: it validates the inputs,
allocates the output, launches on PyTorch's current stream and counts the
launch in ``flash_attention_cuda.launches``.  Its plain version is
``ref.reference_attention``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .build import load_library, stream_handle

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         softmax_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """q: (B, Hq, S, hd); k/v: (B, Hkv, T, hd) with Hq % Hkv == 0, all on
    one CUDA device, float32 or bfloat16, hd in {32, 64, 128}.  Any batch,
    head and row strides are taken (the model passes ``(B, S, H, hd)``
    activations transposed); the head dim must be unit-stride.  Returns
    ``torch.empty_like(q)`` filled: (B, Hq, S, hd) in q's dtype and, for a
    dense q, q's layout."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects 4-D q, k and v")
    b, hq, s, hd = q.shape
    _, hkv, t, _ = k.shape
    if tuple(k.shape) != (b, hkv, t, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported (one of {HEAD_DIMS})")
    if s < 1 or t < 1:
        raise ValueError("flash_attention needs S >= 1 and T >= 1")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} dtype {x.dtype} differs from q's")
        if x.stride(3) != 1:
            raise ValueError(f"{name} must be unit-stride in its head dim")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *(st for x in (q, k, v, out) for st in x.stride()[:3]))
    lib = load_library()
    with torch.cuda.device(q.device):
        rc = lib.lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, b, hq, hkv, s, t, hd, code, int(bool(causal)), float(scale),
            stream_handle(q.device))
    lib.check(rc, "flash_attention launch")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
