"""Weights and optimizer state of the reference model in the port's layout.

``params_from_jax`` takes the reference's ``init_params`` pytree as numpy
arrays (``params["layers"]`` stacked on axis 0; an MoE layer's experts
(L, E, D, F) and its f32 router (L, D, E); a hybrid layer's ``ssm``
sub-dict, its f32 ``a_log`` included, and ``ln_ssm``; for xLSTM the
``mlstm`` stack (n_groups, m_per_group, ...) and the ``slstm`` stack
(n_s, ...), gate weights in f32) and returns the port's parameter dict
with the stacks split per layer, each leaf in its own dtype, so the two
packages can be compared on identical weights.  ``opt_state_from_jax``
does the same for the reference's ``AdamWState``, ``comp_state_from_jax`` for its
gradient-compression ``CompressionState``, and ``cache_from_jax`` for its
decode state, so a decode can be compared mid-stream.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.api import resolve_device
from ..distributed.compression import CompressionState
from ..optim import AdamWState
from .attention import KVCache
from .blocks import BlockCache
from .lm import DecodeState, xlstm_meta
from .mla import MLACache
from .ssm import SSMCache
from .xlstm import MLSTMCache, SLSTMCache


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _at(tree: Any, index: tuple, dev: torch.device) -> Any:
    """One layer of a stacked pytree: every leaf at ``index``."""
    return _map(tree, lambda a: _to_tensor(np.asarray(a)[index], dev))


def params_from_jax(np_params: Dict[str, Any], cfg: ModelConfig,
                    device: Any = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    stacks = ("layers", "mlstm", "slstm")
    out = {k: _map(v, lambda a: _to_tensor(a, dev))
           for k, v in np_params.items() if k not in stacks}
    if "layers" in np_params:
        out["layers"] = [_at(np_params["layers"], (i,), dev)
                         for i in range(cfg.n_layers)]
    if "mlstm" in np_params:
        meta = xlstm_meta(cfg)
        out["mlstm"] = [[_at(np_params["mlstm"], (g, j), dev)
                         for j in range(meta["m_per_group"])]
                        for g in range(meta["n_groups"])]
        if "slstm" in np_params:
            out["slstm"] = [_at(np_params["slstm"], (i,), dev)
                            for i in range(meta["n_s"])]
    return out


def opt_state_from_jax(np_state: Any, cfg: ModelConfig,
                       device: Any = None) -> AdamWState:
    """The reference's ``AdamWState`` (numpy leaves: ``step``, and ``m``/``v``
    laid out as its params) as the port's."""
    dev = resolve_device(device)
    return AdamWState(step=_to_tensor(np_state.step, dev),
                      m=params_from_jax(np_state.m, cfg, dev),
                      v=params_from_jax(np_state.v, cfg, dev))


def comp_state_from_jax(np_state: Any, cfg: ModelConfig,
                        device: Any = None) -> CompressionState:
    """The reference's ``CompressionState`` (numpy leaves: ``error`` laid
    out as its params, f32) as the port's."""
    return CompressionState(error=params_from_jax(np_state.error, cfg,
                                                  resolve_device(device)))


def cache_from_jax(np_state: Any, cfg: ModelConfig,
                   device: Any = None) -> DecodeState:
    """The reference's ``DecodeState`` (numpy leaves; its caches stacked on
    a leading layer axis: a ``KVCache``'s k/v (L, B, Smax, Hkv, hd) or an
    ``MLACache``'s c_kv (L, B, Smax, r_kv) and k_rope (L, B, Smax, rope),
    length (L,); in the hybrid family an ``SSMCache``'s conv (L, B, K-1,
    di) and f32 h (L, B, di, N)) as the port's list of per-layer caches.
    For xLSTM its ``xlstm`` pair: the ``MLSTMCache`` fields stacked
    (n_groups, m_per_group, ...) and the ``SLSTMCache`` fields
    (n_groups, ...), as the port's ``[g][j]`` and ``[g]`` lists."""
    dev = resolve_device(device)

    def layer(kind, tree, *index):
        return kind(*(_to_tensor(np.asarray(getattr(tree, f))[index], dev)
                      for f in kind._fields))

    if np_state.xlstm is not None:
        meta = xlstm_meta(cfg)
        m_c, s_c = np_state.xlstm
        return DecodeState(caches=None, xlstm=(
            [[layer(MLSTMCache, m_c, g, j)
              for j in range(meta["m_per_group"])]
             for g in range(meta["n_groups"])],
            [layer(SLSTMCache, s_c, g) for g in range(meta["n_s"])]))
    kind = MLACache if cfg.attn_kind == "mla" else KVCache
    ssm = np_state.caches.ssm
    return DecodeState(caches=[
        BlockCache(kv=layer(kind, np_state.caches.kv, i),
                   ssm=None if ssm is None else layer(SSMCache, ssm, i))
        for i in range(cfg.n_layers)])
