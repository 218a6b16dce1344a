"""Hand-written CUDA flash-attention forward (causal GQA, online softmax).

Port of the TPU kernel ``src/repro/kernels/flash_attention.py``
(``_flash_kernel``, wrapper ``flash_attention``, ``pallas_call`` at line
108).  Like the TPU kernel, it takes any head dim (here up to 256).  Two
CUDA routes, chosen by dtype and head dim alone (``route_of``), never by
a failed build or launch:

* ``"sm90"``, bfloat16 at hd 32, 64, 128 and 256 (the served dtype at
  every full-width model's hd): ``repro_torch/csrc/flash_attention_sm90.cu``,
  TMA loads and ``wgmma`` on the tensor cores with a producer warpgroup
  and two consumer warpgroups; 128-key tiles at hd 32, 64 and 128, 64-key
  tiles at hd 256 (what fits in shared memory).  TMA needs 16-byte
  aligned addresses and strides; an input that breaks that raises instead
  of taking a slower kernel.
* ``"mma"``, float32 at any hd and bfloat16 at every other hd (12 and 16
  at the smoke widths, 48): ``repro_torch/csrc/flash_attention_mma.cu``,
  ``mma.sync`` on the tensor cores with K/V tiles through a ``cp.async``
  ring; f32 runs each product as three TF32 products on split operands
  (3xTF32), which holds f32 to 2e-4 where one TF32 product would not;
  instances at hd 16, 32, 48, 64, 128 and 256, each serving the head dims
  up to its own with the rest of its columns zero.  It takes any pointer
  and stride: the copy width follows their alignment
  (``mma_copy_width``), down to plain loads.

Each source's header says what bounds it on an H100 and how its design
maps the TPU's sequential kv grid axis onto a loop inside one CTA.

``flash_attention_cuda`` is the launch wrapper: it validates the inputs,
allocates the output, launches on PyTorch's current stream and counts
every launch in ``flash_attention_cuda.launches``, the sm90 route's in
``flash_attention_cuda.sm90_launches`` and the mma route's in
``flash_attention_cuda.mma_f32_launches`` and ``mma_bf16_launches``.
Its plain version is ``ref.reference_attention``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from .build import load_library, stream_handle

HEAD_DIMS = (32, 64, 128, 256)   # the sm90 kernel's instances
MAX_HEAD_DIM = 256               # the mma kernel's largest instance
DTYPES = (torch.float32, torch.bfloat16)
TMA_ALIGN = 16  # bytes: TMA's alignment of addresses and strides
# the mma kernel's C entry point and launch counter per dtype
MMA_ENTRY = {torch.float32: ("repro_flash_attention_mma_f32",
                             "mma_f32_launches"),
             torch.bfloat16: ("repro_flash_attention_mma_bf16",
                              "mma_bf16_launches")}


def route_of(dtype: torch.dtype, hd: int) -> str:
    """The route every call at ``(dtype, hd)`` takes: ``"sm90"`` for
    bfloat16 at one of its head dims, ``"mma"`` for everything else."""
    return "sm90" if dtype == torch.bfloat16 and hd in HEAD_DIMS else "mma"


def mma_copy_width(hd: int, itemsize: int,
                   operands: Sequence[Tuple[Sequence[int], Sequence[int],
                                            int]]) -> int:
    """The mma kernel's ``cp.async`` width in bytes: the widest of 16, 8
    and 4 that divides the row's ``hd * itemsize`` bytes, every pointer
    and every (batch, head, row) stride in bytes of the ``(shape, stride,
    data_ptr)`` operands (a dimension of size 1 is never stepped); 0 where
    none does (bfloat16 at an odd hd, stride or pointer), which the kernel
    reads with plain loads."""
    width = math.gcd(16, hd * itemsize)
    for shape, stride, ptr in operands:
        width = math.gcd(width, ptr)
        for dim in range(3):
            if shape[dim] > 1:
                width = math.gcd(width, stride[dim] * itemsize)
    return width if width >= 4 else 0


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
    one CUDA device, float32 or bfloat16, 1 <= hd <= 256.  Any batch, head
    and row strides are taken (the model passes ``(B, S, H, hd)``
    activations transposed); the head dim must be unit-stride, and on the
    sm90 route (``route_of``) pointers and strides must be multiples of 16
    bytes (the mma route takes any).  Returns ``torch.empty_like(q)``
    filled: (B, Hq, S, hd) in q's dtype and, for a dense q, q's layout."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects 4-D q, k and v")
    b, hq, s, hd = q.shape
    _, hkv, t, _ = k.shape
    if tuple(k.shape) != (b, hkv, t, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} not supported (1 to {MAX_HEAD_DIM})")
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
    sm90 = route_of(q.dtype, hd) == "sm90"
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    if sm90:
        per = [sm90_strides(name, x.shape, x.stride(), x.data_ptr(), x.dtype)
               for name, x in (("q", q), ("k", k), ("v", v), ("out", out))]
    else:
        per = [x.stride()[:3] for x in (q, k, v, out)]
    strides = (ctypes.c_longlong * 12)(*(st for x in per for st in x))
    lib = load_library()
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, b, hq, hkv, s, t, hd, int(bool(causal)), float(scale)]
    if sm90:
        entry, counter = lib.lib.repro_flash_attention_sm90, "sm90_launches"
    else:
        name, counter = MMA_ENTRY[q.dtype]
        entry = getattr(lib.lib, name)
        args.append(mma_copy_width(hd, q.dtype.itemsize, [
            (x.shape, x.stride(), x.data_ptr()) for x in (q, k, v)]))
    with torch.cuda.device(q.device):
        rc = entry(*args, stream_handle(q.device))
    lib.check(rc, "flash_attention launch")
    flash_attention_cuda.launches += 1
    setattr(flash_attention_cuda, counter,
            getattr(flash_attention_cuda, counter) + 1)
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.sm90_launches = 0
flash_attention_cuda.mma_f32_launches = 0
flash_attention_cuda.mma_bf16_launches = 0
