"""Weights of the reference model in the port's layout.

``params_from_jax`` takes the reference's ``init_params`` pytree as numpy
arrays (``params["layers"]`` stacked on axis 0) and returns the port's
parameter dict with the stacks split per layer, so the two packages can
be compared on identical weights.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.api import resolve_device


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


def params_from_jax(np_params: Dict[str, Any], cfg: ModelConfig,
                    device: Any = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    out = {k: _map(v, lambda a: _to_tensor(a, dev))
           for k, v in np_params.items() if k != "layers"}
    out["layers"] = [_map(np_params["layers"],
                          lambda a, i=i: _to_tensor(np.asarray(a)[i], dev))
                     for i in range(cfg.n_layers)]
    return out
