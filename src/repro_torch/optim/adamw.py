"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro/optim/adamw.py``: the same clipping, bias correction and
update order, functional (new tensors, no in-place update) so that a
captured train step records it as plain aten nodes.  Parameters and
moments are pytrees of tensors (``torch.utils._pytree``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: torch.dtype = torch.float32   # bfloat16 option


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    m: Any
    v: Any


def init_state(params, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    def zeros(p):
        return torch.zeros_like(p, dtype=cfg.state_dtype)
    dev = pytree.tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=pytree.tree_map(zeros, params),
                      v=pytree.tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    total = None
    for x in pytree.tree_leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply_updates(params, grads, state: AdamWState,
                  cfg: AdamWConfig = AdamWConfig()) -> Tuple[Any, AdamWState]:
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * \
            p.to(torch.float32)
        p_new = p.to(torch.float32) - cfg.lr * delta
        return (p_new.to(p.dtype), m_new.to(cfg.state_dtype),
                v_new.to(cfg.state_dtype))

    p_leaves, tree = pytree.tree_flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        p_leaves, pytree.tree_leaves(grads), pytree.tree_leaves(state.m),
        pytree.tree_leaves(state.v))]
    new_params, new_m, new_v = (pytree.tree_unflatten([o[i] for o in out], tree)
                                for i in range(3))
    return new_params, AdamWState(step=step, m=new_m, v=new_v)
