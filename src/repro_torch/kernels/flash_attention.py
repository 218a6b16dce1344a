"""Hand-written CUDA flash-attention forward (causal GQA, online softmax).

Port of the TPU kernel ``src/repro/kernels/flash_attention.py``
(``_flash_kernel``, wrapper ``flash_attention``, ``pallas_call`` at line
108).  Two CUDA routes, chosen by dtype:

* bfloat16 (the served dtype): ``repro_torch/csrc/flash_attention_sm90.cu``,
  TMA loads and ``wgmma`` on the tensor cores with a producer warpgroup
  and two consumer warpgroups.  TMA needs 16-byte aligned addresses and
  strides; an input that breaks that raises instead of taking a slower
  kernel.
* float32: ``repro_torch/csrc/flash_attention.cu``, f32 FMAs from shared
  memory (the tensor cores' TF32 would not hold f32 to 2e-4).

Each source's header says what bounds it on an H100 (bytes up to
S ~ 1200, operations beyond) and how its design maps the TPU's sequential
kv grid axis onto a loop inside one CTA.

``flash_attention_cuda`` is the launch wrapper: it validates the inputs,
allocates the output, launches on PyTorch's current stream and counts
every launch in ``flash_attention_cuda.launches`` and the bf16 route's in
``flash_attention_cuda.sm90_launches``.  Its plain version is
``ref.reference_attention``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from .build import load_library, stream_handle

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
TMA_ALIGN = 16  # bytes: TMA's alignment of addresses and strides


def sm90_strides(name: str, shape: Sequence[int], stride: Sequence[int],
                 data_ptr: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """The (batch, head, row) element strides that the sm90 kernel gets for
    one ``(B, H, rows, hd)`` operand, or ``ValueError`` if its pointer or a
    stride in bytes is not a multiple of 16.  A dimension of size 1 is
    never stepped, so its stride is replaced by ``hd`` (which is)."""
    if dtype != torch.bfloat16:
        raise ValueError(f"{name}: the sm90 kernel takes bfloat16, not {dtype}")
    size = dtype.itemsize
    if data_ptr % TMA_ALIGN:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned "
                         f"(address % 16 = {data_ptr % TMA_ALIGN})")
    out = []
    for dim, what in enumerate(("batch", "head", "row")):
        st = stride[dim] if shape[dim] > 1 else shape[3]
        if (st * size) % TMA_ALIGN:
            raise ValueError(f"{name}: {what} stride of {st * size} bytes is "
                             f"not a multiple of 16 (16-byte TMA alignment)")
        out.append(st)
    return tuple(out)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         softmax_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """q: (B, Hq, S, hd); k/v: (B, Hkv, T, hd) with Hq % Hkv == 0, all on
    one CUDA device, float32 or bfloat16, hd in {32, 64, 128}.  Any batch,
    head and row strides are taken (the model passes ``(B, S, H, hd)``
    activations transposed); the head dim must be unit-stride, and in
    bfloat16 pointers and strides must be multiples of 16 bytes.  Returns
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
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    sm90 = q.dtype == torch.bfloat16
    if sm90:
        per = [sm90_strides(name, x.shape, x.stride(), x.data_ptr(), x.dtype)
               for name, x in (("q", q), ("k", k), ("v", v), ("out", out))]
    else:
        per = [x.stride()[:3] for x in (q, k, v, out)]
    strides = (ctypes.c_longlong * 12)(*(st for x in per for st in x))
    lib = load_library()
    entry = lib.lib.repro_flash_attention_sm90 if sm90 \
        else lib.lib.repro_flash_attention
    with torch.cuda.device(q.device):
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   strides, b, hq, hkv, s, t, hd, int(bool(causal)),
                   float(scale), stream_handle(q.device))
    lib.check(rc, "flash_attention launch")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.sm90_launches += int(sm90)
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.sm90_launches = 0
