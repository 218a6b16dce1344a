"""Step functions: the serving prefill step and the training step driven
by ``optimize``, and the decode step of the serving loop
(``repro/launch/steps.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils import _pytree as pytree

from ..configs.base import ModelConfig
from ..distributed.compression import compress_gradients
from ..models import decode_step, loss_fn
from ..models import prefill as model_prefill
from ..optim import AdamWConfig, apply_updates


def adamw_config_for(cfg: ModelConfig) -> AdamWConfig:
    return AdamWConfig(state_dtype=torch.bfloat16
                       if cfg.optimizer_dtype == "bfloat16" else torch.float32)


def _grad_fn(cfg: ModelConfig, grad_accum: int, impl: Optional[str]):
    """``grads(params, batch) -> (loss, grads)``, optionally micro-batched
    (gradient accumulation, ``repro/launch/steps.py:22-48``).

    Accumulation cuts the activation peak (logits and attention
    transients scale with the micro-batch) at no FLOP cost.  The batch
    splits into ``grad_accum`` equal micro-batches along ``b``; the grads
    accumulate in the params' own dtype, and the mean loss and grads come
    back.  The reference scans the micro-batches; torch's scan cannot
    hold ``autograd.grad`` in its body, so a Python loop unrolls them, as
    the model unrolls its layers."""
    def grads_of(leaves, tree, batch):
        with torch.enable_grad():
            loss = loss_fn(cfg, pytree.tree_unflatten(leaves, tree), batch,
                           impl)
            return loss, torch.autograd.grad(loss, leaves)

    def grads(params, batch):
        leaves, tree = pytree.tree_flatten(params)
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_() for p in leaves]
        if grad_accum == 1:
            loss, g = grads_of(leaves, tree, batch)
            return loss.detach(), pytree.tree_unflatten(list(g), tree)
        b = pytree.tree_leaves(batch)[0].shape[0]
        if isinstance(b, torch.SymInt):
            raise ValueError(
                f"grad_accum={grad_accum} splits the batch into equal "
                f"micro-batches, so it needs a static batch size; this "
                f"batch's size is symbolic")
        if b % grad_accum:
            raise ValueError(f"grad_accum={grad_accum} does not divide the "
                             f"batch size {b}")
        m = b // grad_accum
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        acc = [torch.zeros_like(p) for p in leaves]
        for i in range(grad_accum):
            micro = pytree.tree_map(lambda x: x[i * m:(i + 1) * m], batch)
            loss, g = grads_of(leaves, tree, micro)
            loss_acc = loss_acc + loss.detach()
            acc = [a + gi for a, gi in zip(acc, g)]
            del g         # not held through the next micro-batch's pass
        inv = 1.0 / grad_accum
        return loss_acc * inv, pytree.tree_unflatten(
            [a * inv for a in acc], tree)
    return grads


def make_train_step(cfg: ModelConfig, *, compress: bool = False,
                    grad_accum: int = 1, impl: Optional[str] = None):
    """``train_step(params, opt_state, batch) -> (loss, params,
    opt_state)``; with ``compress``, ``train_step(params, opt_state,
    comp_state, batch) -> (loss, params, opt_state, comp_state)``: the
    grads go through int8 error-feedback compression
    (``distributed.compression``) before the update.

    The gradients are taken inside the step with ``torch.autograd.grad``,
    so ``optimize`` captures forward, backward and the AdamW update as one
    flat graph.  ``grad_accum > 1`` splits a static batch into that many
    micro-batches (``_grad_fn``).  ``impl`` is passed to the kernel ops
    (``"ref"``: plain PyTorch)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    ocfg = adamw_config_for(cfg)
    gfn = _grad_fn(cfg, grad_accum, impl)

    if compress:
        def train_step(params, opt_state, comp_state, batch):
            loss, grads = gfn(params, batch)
            grads, comp_state = compress_gradients(grads, comp_state)
            new_params, new_opt = apply_updates(params, grads, opt_state,
                                                ocfg)
            return loss, new_params, new_opt, comp_state
        return train_step

    def train_step(params, opt_state, batch):
        loss, grads = gfn(params, batch)
        new_params, new_opt = apply_updates(params, grads, opt_state, ocfg)
        return loss, new_params, new_opt
    return train_step


def make_prefill_step(cfg: ModelConfig, impl: Optional[str] = None):
    """``prefill_step(params, batch) -> (B, V)`` last-position logits.

    ``impl`` is passed to the kernel ops (``"ref"``: plain PyTorch)."""
    def prefill_step(params, batch):
        return model_prefill(cfg, params, batch, impl)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, state, inp) -> (logits (B,1,V), state)``: one
    decode token over the KV cache (``models.decode_step``), run eagerly."""
    def serve_step(params, state, inp):
        return decode_step(cfg, params, state, inp)
    return serve_step
