"""Step functions driven by ``optimize``: the serving prefill step and the
training step (``repro/launch/steps.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils import _pytree as pytree

from ..configs.base import ModelConfig
from ..models import loss_fn
from ..models import prefill as model_prefill
from ..optim import AdamWConfig, apply_updates


def adamw_config_for(cfg: ModelConfig) -> AdamWConfig:
    return AdamWConfig(state_dtype=torch.bfloat16
                       if cfg.optimizer_dtype == "bfloat16" else torch.float32)


def make_train_step(cfg: ModelConfig, *, compress: bool = False,
                    grad_accum: int = 1, impl: Optional[str] = None):
    """``train_step(params, opt_state, batch) -> (loss, params, opt_state)``.

    The gradients are taken inside the step with ``torch.autograd.grad``,
    so ``optimize`` captures forward, backward and the AdamW update as one
    flat graph.  ``impl`` is passed to the kernel ops (``"ref"``: plain
    PyTorch).  Gradient compression and accumulation are not ported yet."""
    if compress:
        raise NotImplementedError("gradient compression is not ported yet")
    if grad_accum != 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    ocfg = adamw_config_for(cfg)

    def train_step(params, opt_state, batch):
        leaves, tree = pytree.tree_flatten(params)
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_() for p in leaves]
            loss = loss_fn(cfg, pytree.tree_unflatten(leaves, tree), batch,
                           impl)
            grads = torch.autograd.grad(loss, leaves)
        new_params, new_opt = apply_updates(
            params, pytree.tree_unflatten(list(grads), tree), opt_state, ocfg)
        return loss.detach(), new_params, new_opt
    return train_step


def make_prefill_step(cfg: ModelConfig, impl: Optional[str] = None):
    """``prefill_step(params, batch) -> (B, V)`` last-position logits.

    ``impl`` is passed to the kernel ops (``"ref"``: plain PyTorch)."""
    def prefill_step(params, batch):
        return model_prefill(cfg, params, batch, impl)
    return prefill_step
