"""PyTorch/CUDA port of the BladeDISC++ reproduction.

Beside the JAX package ``repro`` (the reference), this package runs the
same pipeline — symbolic capture, op scheduling, symbolic memory planning,
lowering and the register VM — on PyTorch, with the reference's two TPU
kernels (flash attention and RMSNorm) written by hand in CUDA for Hopper.
It imports ``torch`` and never ``jax`` or ``repro``.
"""
