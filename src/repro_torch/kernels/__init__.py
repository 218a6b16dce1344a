"""The port's kernels: hand-written CUDA for Hopper, with plain versions.

Importing this package registers the custom ops and builds nothing: the
CUDA library is compiled at the first launch on a CUDA tensor.
"""
from .flash_attention import flash_attention_cuda
from .ops import (flash_attention, masked_select, nonzero_pad, rmsnorm,
                  topk_dynamic, unique_bounded)
from .ref import reference_attention, reference_rmsnorm
from .rmsnorm import rmsnorm_cuda

__all__ = ["flash_attention", "flash_attention_cuda", "masked_select",
           "nonzero_pad", "reference_attention", "reference_rmsnorm",
           "rmsnorm", "rmsnorm_cuda", "topk_dynamic", "unique_bounded"]
