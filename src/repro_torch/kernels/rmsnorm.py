"""Hand-written CUDA fused RMSNorm.

Port of the TPU kernel ``src/repro/kernels/rmsnorm.py``
(``_rmsnorm_kernel``, wrapper ``rmsnorm``, ``pallas_call`` at line 47).
The kernel source is ``repro_torch/csrc/rmsnorm.cu``; its header says what
bounds it on an H100 (bytes) and why it needs no padding of ``d``.

``rmsnorm_cuda`` is the launch wrapper: it validates the inputs, allocates
the output, launches on PyTorch's current stream and counts the launch in
``rmsnorm_cuda.launches``.  Its plain version is ``ref.reference_rmsnorm``.
"""
from __future__ import annotations

import torch

from .build import load_library, stream_handle

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) contiguous on a CUDA device; scale: (d,) of x's dtype.
    float32 or bfloat16.  Returns x's shape and dtype."""
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError("rmsnorm expects x of shape (..., d) with d >= 1")
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    for name, t in (("x", x), ("scale", scale)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on x's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scale.dtype != x.dtype:
        raise ValueError(f"scale dtype {scale.dtype} differs from x's")
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"dtype {x.dtype} not supported (float32, bfloat16)")
    out = torch.empty_like(x)
    n_rows = x.numel() // d
    if n_rows == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.lib.repro_rmsnorm(x.data_ptr(), scale.data_ptr(),
                                   out.data_ptr(), n_rows, d, code,
                                   float(eps), stream_handle(x.device))
    lib.check(rc, "rmsnorm launch")
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0
