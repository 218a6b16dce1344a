"""Hand-written CUDA fused RMSNorm.

Port of the TPU kernel ``src/repro/kernels/rmsnorm.py``
(``_rmsnorm_kernel``, wrapper ``rmsnorm``, ``pallas_call`` at line 47).
The kernel source is ``repro_torch/csrc/rmsnorm.cu``; its header says what
bounds it on an H100 (bytes) and how its two paths meet that.

:func:`rmsnorm_geometry` picks the path and its shape from ``(d, dtype)``
and the pointers' 16-byte alignment alone, never from the row count, so a
row's arithmetic and reduction order are the same in every call.  The
wrapper, the selector's cost model (``variants.rmsnorm_cost``) and the
tests read this one function.

``rmsnorm_cuda`` is the launch wrapper: it validates the inputs, allocates
the output, launches on PyTorch's current stream and counts the launch in
``rmsnorm_cuda.launches`` and in ``reg_launches`` or ``loop_launches`` by
the path it took.  Its plain version is ``ref.reference_rmsnorm``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .build import load_library, stream_handle

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VEC_BYTES = 16          # one vector load or store
CTA_THREADS = 256       # a CTA on both paths
# the vectors a thread holds on the register path (csrc/rmsnorm.cu's
# VecWidth<T>::K, its instances): 8 bf16 vectors are 64 floats once
# converted, past the 64 registers a thread of 4 CTAs an SM has, and
# spill (ptxas -v, chip_smoke.py phase 1)
MAX_VECS = {torch.float32: 8, torch.bfloat16: 7}
ROW_THREADS = (32, 64, 128, 256)
# csrc/rmsnorm.cu's shared memory: rmsnorm_rows' float red[8] and a copy
# of scale (d elements, at most 32 KB), rmsnorm_loop's float red[32]
REG_SMEM_BYTES = (CTA_THREADS // 32) * 4
LOOP_SMEM_BYTES = 32 * 4
MAX_SMEM_BYTES = REG_SMEM_BYTES + max(
    ROW_THREADS[-1] * k * VEC_BYTES for k in MAX_VECS.values())


@dataclass(frozen=True)
class NormGeometry:
    """How the kernel covers a row of ``d`` elements.

    ``path`` is ``"reg"`` (the row in registers, ``rows_per_cta`` rows a
    CTA, ``threads_per_row`` threads holding up to ``vecs_per_thread``
    16-byte vectors of ``vec`` elements each) or ``"loop"`` (one CTA of
    ``cta_threads`` per row, two passes; ``vecs_per_thread`` 0).
    ``smem_bytes`` is the CTA's shared memory."""

    path: str
    d: int
    vec: int
    threads_per_row: int
    vecs_per_thread: int
    rows_per_cta: int
    cta_threads: int
    smem_bytes: int


def max_reg_width(dtype: torch.dtype) -> int:
    """The widest row the register path holds: 256 threads of
    ``MAX_VECS`` vectors (14336 in bf16, 8192 in f32)."""
    return ROW_THREADS[-1] * MAX_VECS[dtype] * (VEC_BYTES // dtype.itemsize)


@functools.lru_cache(maxsize=None)
def rmsnorm_geometry(d: int, dtype: torch.dtype,
                     aligned: bool = True) -> NormGeometry:
    """The geometry of a row of ``d`` elements of ``dtype``; ``aligned``:
    x, y and scale all start on a 16-byte boundary.

    The register path takes a whole number of 16-byte vectors up to
    :func:`max_reg_width`, with the fewest threads a row (at least a warp)
    at which no thread holds more than ``MAX_VECS`` vectors: in bf16 one
    warp a row up to d 1536, two at 2048-3072, four at 4096-7168.
    Everything else takes the loop path."""
    vec = VEC_BYTES // dtype.itemsize
    nvec = d // vec
    if not aligned or d % vec or d > max_reg_width(dtype):
        return NormGeometry("loop", d, vec, CTA_THREADS, 0, 1, CTA_THREADS,
                            LOOP_SMEM_BYTES)
    tpr = next(t for t in ROW_THREADS if t * MAX_VECS[dtype] >= nvec)
    return NormGeometry("reg", d, vec, tpr, -(-nvec // tpr),
                        CTA_THREADS // tpr, CTA_THREADS,
                        REG_SMEM_BYTES + d * dtype.itemsize)


def tensor_geometry(x: torch.Tensor, scale: torch.Tensor,
                    out: torch.Tensor) -> NormGeometry:
    """:func:`rmsnorm_geometry` of a call: x's width and dtype, and whether
    x, scale and out all start on a 16-byte boundary."""
    aligned = (x.data_ptr() | scale.data_ptr() | out.data_ptr()) \
        % VEC_BYTES == 0
    return rmsnorm_geometry(x.shape[-1], x.dtype, aligned)


def launch_rmsnorm(x: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
                   geo: NormGeometry, eps: float) -> None:
    """Launch the kernel on checked tensors with the geometry ``geo`` and
    count it."""
    lib = load_library()
    reg = geo.path == "reg"
    dev = x.device
    args = (x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            x.numel() // geo.d, geo.d, _DTYPE_CODES[x.dtype], float(eps),
            geo.threads_per_row if reg else 0, geo.vecs_per_thread)
    if dev.index == torch.cuda.current_device():
        rc = lib.lib.repro_rmsnorm(*args, stream_handle(dev))
    else:
        with torch.cuda.device(dev):
            rc = lib.lib.repro_rmsnorm(*args, stream_handle(dev))
    lib.check(rc, "rmsnorm launch")
    rmsnorm_cuda.launches += 1
    if reg:
        rmsnorm_cuda.reg_launches += 1
    else:
        rmsnorm_cuda.loop_launches += 1


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) contiguous on a CUDA device; scale: (d,) of x's dtype.
    float32 or bfloat16.  Returns x's shape and dtype."""
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError("rmsnorm expects x of shape (..., d) with d >= 1")
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    dev = x.device
    for name, t in (("x", x), ("scale", scale)):
        if dev.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be on x's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scale.dtype != x.dtype:
        raise ValueError(f"scale dtype {scale.dtype} differs from x's")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} not supported (float32, bfloat16)")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    launch_rmsnorm(x, scale, out, tensor_geometry(x, scale, out), eps)
    return out


rmsnorm_cuda.launches = 0
rmsnorm_cuda.reg_launches = 0
rmsnorm_cuda.loop_launches = 0
