"""Kernel entry points, registered as PyTorch custom ops.

``repro_torch::flash_attention`` and ``repro_torch::rmsnorm`` are
``torch.library.custom_op``s with fake implementations, so a captured
graph keeps exactly one node per kernel call — the counterpart of the
reference's ``flash_attention`` / ``rmsnorm`` primitives
(``repro/kernels/ops.py:109-128``).

Dispatch rules (``impl``):

* ``"ref"`` and the plain variants' names (``"ref_dense"``,
  ``"ref_unfused"``) run the plain PyTorch version, on any device;
* a kernel variant's name (``"sm90_bm128_bn128"``,
  ``"mma_f32_bq64_bkv64"`` and ``"mma_bf16_bq64_bkv64"`` for flash
  attention, ``"cuda_reg_rows"`` for RMSNorm; see ``kernels/variants.py``)
  launches that kernel on a CUDA tensor and raises if the tensor's dtype
  (or, for flash attention, its head dim) is not one the kernel takes;
  on a CPU tensor it runs the plain version, the stand-in that Pallas
  interpret mode was for the reference;
* ``None`` lets the tensors' device decide: CPU tensors take the plain
  version, CUDA tensors launch the hand-written kernel of their dtype
  (flash attention: of their dtype and head dim, ``route_of``).

A CUDA tensor never falls back to the plain version or to another route:
the wrapper launches the kernel it was asked for or raises.

Each op returns its output in ``torch.empty_like`` of its first input, on
every route and in its fake, so a captured graph's strides hold at run
time: the model hands flash attention its ``(B, S, H, hd)`` activations
transposed and gets the output back in that layout.

Both ops are differentiable (``register_autograd``): the backward is the
plain PyTorch gradient of the op's function (``ref.*_backward``) on every
route, so a captured train step records it as aten nodes.  The reference
has no backward kernel (its primitives define no JVP), so none is owed.

The four value-dependent ops (``nonzero_pad``, ``masked_select``,
``topk_dynamic``, ``unique_bounded``) are ``repro_torch::<name>`` custom
ops that *introduce* a bounded dim (``core.ir.dynamism``): each returns
``(payload, count)``, with the payload tight (``count`` rows, not the
cap) on every device, and a fake whose payload's leading dim is a fresh
unbacked size, which capture turns into a bound symbol ``__b<k>``.  The
reference implements them in plain jnp, so plain PyTorch is their port.
Their ``pad_to`` argument is set by capture only (see ``ref.tight_*``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.ir.dynamism import DimIntroSpec, register_introduces_dim
from . import ref as _ref
from .flash_attention import flash_attention_cuda, route_of
from .rmsnorm import rmsnorm_cuda

# impl name -> the dtype its kernel takes (None: any); "ref*" are plain
FLASH_IMPLS = {None: None, "ref": None, "ref_dense": None,
               "sm90_bm128_bn128": torch.bfloat16,
               "mma_f32_bq64_bkv64": torch.float32,
               "mma_bf16_bq64_bkv64": torch.bfloat16}
RMSNORM_IMPLS = {None: None, "ref": None, "ref_unfused": None,
                 "cuda_reg_rows": None}


def _route(impl: Optional[str], x: torch.Tensor, impls) -> str:
    """``"ref"`` (the plain version) or ``"cuda"`` (the kernel)."""
    if impl not in impls:
        raise ValueError(f"impl must be one of {list(impls)}, got {impl!r}")
    if impl is not None and impl.startswith("ref"):
        return "ref"
    want = impls[impl]
    if want is not None and x.dtype != want:
        raise ValueError(f"impl {impl!r} takes {want}, not {x.dtype}")
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
    route = _route(impl, q, FLASH_IMPLS)
    # a kernel variant's name starts with its route (``sm90_``, ``mma_``)
    if impl is not None and not impl.startswith("ref") \
            and not impl.startswith(route_of(q.dtype, q.shape[-1])):
        raise ValueError(f"impl {impl!r} does not take head dim "
                         f"{q.shape[-1]} in {q.dtype}")
    if route == "ref":
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
    if _route(impl, x, RMSNORM_IMPLS) == "ref":
        return _ref.reference_rmsnorm(x, scale, eps)
    return rmsnorm_cuda(x, scale, eps=eps)


@rmsnorm.register_fake
def _(x, scale, eps=1e-6, impl=None):
    return torch.empty_like(x)


# -- autograd -------------------------------------------------------------------


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, softmax_scale, _impl = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.softmax_scale = causal, softmax_scale


def _flash_backward(ctx, grad):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = _ref.reference_attention_backward(
        q, k, v, grad, causal=ctx.causal, softmax_scale=ctx.softmax_scale)
    return dq, dk, dv, None, None, None


def _rmsnorm_setup(ctx, inputs, output):
    x, scale, eps, _impl = inputs
    ctx.save_for_backward(x, scale)
    ctx.eps = eps


def _rmsnorm_backward(ctx, grad):
    x, scale = ctx.saved_tensors
    dx, dscale = _ref.reference_rmsnorm_backward(x, scale, grad, ctx.eps)
    return dx, dscale, None, None


flash_attention.register_autograd(_flash_backward, setup_context=_flash_setup)
rmsnorm.register_autograd(_rmsnorm_backward, setup_context=_rmsnorm_setup)


# -- value-dependent bounded ops (dynamism introducers) -------------------------


def _bounded_fake(x: torch.Tensor, dtype: Optional[torch.dtype] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A payload whose leading dim is a fresh unbacked size, and the int32
    count scalar."""
    n = torch.library.get_ctx().new_dynamic_size()
    return (x.new_empty((n,) + tuple(x.shape[1:]),
                        dtype=dtype if dtype is not None else x.dtype),
            x.new_empty((), dtype=torch.int32))


@torch.library.custom_op("repro_torch::nonzero_pad", mutates_args=())
def nonzero_pad(x: torch.Tensor, pad_to: int = -1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the nonzero entries of 1-D ``x`` -> ``(idx, count)``:
    ``idx`` is int32 with ``count`` entries.  Under ``optimize`` its length
    is a bounded dim ``b <= len(x)``."""
    return _ref.tight_nonzero(x, pad_to)


@nonzero_pad.register_fake
def _(x, pad_to=-1):
    return _bounded_fake(x, torch.int32)


@torch.library.custom_op("repro_torch::masked_select", mutates_args=())
def masked_select(x: torch.Tensor, mask: torch.Tensor, pad_to: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows of ``x`` (leading axis) where 1-D ``mask`` holds, in order ->
    ``(rows, count)``."""
    return _ref.tight_masked_select(x, mask, pad_to)


@masked_select.register_fake
def _(x, mask, pad_to=-1):
    return _bounded_fake(x)


@torch.library.custom_op("repro_torch::topk_dynamic", mutates_args=())
def topk_dynamic(x: torch.Tensor, k: torch.Tensor, pad_to: int = -1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The largest ``k`` values of 1-D ``x`` with a *data-dependent* ``k``
    (an int32 scalar tensor), descending -> ``(vals, count)``."""
    return _ref.tight_topk_dynamic(x, k, pad_to)


@topk_dynamic.register_fake
def _(x, k, pad_to=-1):
    return _bounded_fake(x)


@torch.library.custom_op("repro_torch::unique_bounded", mutates_args=())
def unique_bounded(x: torch.Tensor, pad_to: int = -1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted distinct values of 1-D ``x`` -> ``(unique, count)``."""
    return _ref.tight_unique_bounded(x, pad_to)


@unique_bounded.register_fake
def _(x, pad_to=-1):
    return _bounded_fake(x)


# the reference's spec for all four: payload out 0, count out 1, the
# payload's dim 0 bounded by input 0's dim 0
for _op in (nonzero_pad, masked_select, topk_dynamic, unique_bounded):
    register_introduces_dim(str(_op._opoverload), DimIntroSpec())
