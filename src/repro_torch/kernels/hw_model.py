"""The hardware model of the kernel-variant cost model: an NVIDIA Hopper card.

The reference describes a TPU v5e (``repro/kernels/hw_model.py``: MXU and
VPU rates, 16 MiB of VMEM).  The port's kernels run on an H100, so its
cost model (:mod:`.variants`) prices them against what a Hopper card
offers:

* streaming multiprocessors, shared memory per block (the opt-in maximum)
  and per SM, and registers per SM — the *occupancy* and *validity*
  constraints of a CUDA kernel (a variant whose shared memory exceeds the
  per-block maximum cannot launch);
* HBM bandwidth, the bf16 and TF32 tensor-core rates and the f32 rate
  outside the tensor cores — the roofline terms;
* a host cost per kernel launch — the term that counts the plain
  versions' many launches against a fused kernel's one;
* ``max_transient_bytes`` — the most device memory a variant may
  allocate inside one op beyond the output the memory plan counts.  The
  plain attention materialises its ``b·hq·s·t`` f32 scores; the plan does
  not see them, so a plain variant whose transients could exceed this is
  invalid for the range (see ``variants.variant_transient_bytes``).

``DEFAULT_HW`` holds the published constants of an H100 SXM5 80GB and is
what a CPU plan (the tests) prices against.  :meth:`HardwareModel.from_device`
reads the SM count, shared memory, registers and threads of the card a
plan runs on from ``torch.cuda.get_device_properties`` (PyTorch 2.11, the
card's, has every one of those fields); the rates stay the published
ones, as PyTorch cannot read them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

# torch.cuda device-property field of each hardware field read from the card
_TORCH_FIELD = {"sm_count": "multi_processor_count",
                "smem_per_block_optin": "shared_memory_per_block_optin",
                "smem_per_sm": "shared_memory_per_multiprocessor",
                "regs_per_sm": "regs_per_multiprocessor",
                "max_threads_per_sm": "max_threads_per_multi_processor"}


@dataclass(frozen=True)
class HardwareModel:
    """Per-card constants consumed by the kernel-variant cost model.

    Defaults: NVIDIA H100 SXM5 80GB.  SMs, HBM3 rate and the three FLOP
    rates are NVIDIA's H100 data sheet (dense, no sparsity, at the 700 W
    limit); shared memory and registers are the CUDA C++ Programming
    Guide's limits for compute capability 9.0."""

    name: str = "H100 SXM5 80GB"
    sm_count: int = 132                      # data sheet
    smem_per_block_optin: int = 227 * 1024   # CC 9.0: 227 KiB per block
    smem_per_sm: int = 228 * 1024            # CC 9.0: 228 KiB per SM
    regs_per_sm: int = 64 * 1024             # CC 9.0: 64 Ki 32-bit registers
    max_threads_per_sm: int = 2048           # CC 9.0
    hbm_bw: float = 3.35e12                  # HBM3 bytes/s, data sheet
    tensor_flops: float = 989e12             # bf16 dense tensor-core FLOP/s
    tf32_flops: float = 495e12               # TF32 dense tensor-core FLOP/s
    fp32_flops: float = 67e12                # f32 FLOP/s off the tensor cores
    # host time of one kernel launch from eager PyTorch (dispatcher and
    # cudaLaunchKernel): an estimate of the order such a call costs on a
    # server CPU, not a measurement of this port; chip_smoke.py phase 7(d)
    # times the variants where this term dominates
    launch_s: float = 5e-6
    # what chip_smoke.py's allocator check grants one op beyond the bytes
    # the plan counts: the caching allocator's block overhead of one live
    # tensor over 1 MiB (1 MiB + 512 B; ``LARGE_OVERHEAD`` there)
    max_transient_bytes: int = (1 << 20) + 512

    @classmethod
    def from_device(cls, device: Any = None) -> "HardwareModel":
        """The model of the CUDA card ``device`` (default: the current
        one): SM count, shared memory per block (opt-in) and per SM,
        registers and threads per SM read from the card; the published
        rates of ``DEFAULT_HW`` otherwise."""
        import torch
        dev = torch.device("cuda" if device is None else device)
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        props = torch.cuda.get_device_properties(index)
        return replace(DEFAULT_HW, name=props.name,
                       **{key: int(getattr(props, field))
                          for key, field in _TORCH_FIELD.items()})

    def with_smem(self, smem_per_block_optin: int) -> "HardwareModel":
        """The same card with another per-block shared-memory limit (tests
        shrink it to watch the valid variant set contract)."""
        return replace(self, smem_per_block_optin=smem_per_block_optin)


DEFAULT_HW = HardwareModel()
