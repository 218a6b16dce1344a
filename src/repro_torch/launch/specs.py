"""``TensorSpec`` stand-ins for every input of a step: its batch, a
decode step's input and cache, the weights and the optimizer state.

Port of ``repro/launch/specs.py``: the batch a training or prefill step
takes, per input mode, the one-token (or one-frame) input of a decode
step, the decode state it carries, the parameters and the AdamW state,
and ``input_specs(cfg, shape_name)``, the inputs of every (arch x input
shape) dry-run cell (``configs.base.SHAPES``).  The batch specs take ints
or ``SymDim``s, so they serve ``optimize``'s symbolic capture as well as
a concrete shape.  The trees are built on the meta device, so nothing is
allocated, whatever the model's size.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils import _pytree as pytree

from ..configs.base import SHAPES, ModelConfig
from ..core.ir.capture import SymDim, TensorSpec, spec_like
from ..models import init_cache, init_params
from ..optim import init_state
from .steps import adamw_config_for


def batch_specs(cfg: ModelConfig, batch: Any, seq: Any) -> Dict[str, TensorSpec]:
    """The step's batch: ``tokens``/``labels`` (B, S); ``frame_embed``
    (B, S, D) and ``labels`` (B, S, K) in ``embeddings`` mode; in ``vlm``
    mode ``vis_embed`` (B, vis_tokens, D) and ``tokens``/``labels`` of the
    text.  An int ``seq`` is the whole sequence, as in the reference (the
    text then takes ``max(seq - vis_tokens, 8)``); a symbolic ``seq``
    names the text's length, so the model's sequence is the expression
    ``seq + vis_tokens``."""
    d, dt = cfg.d_model, cfg.torch_dtype
    if cfg.input_mode == "tokens":
        return {"tokens": TensorSpec((batch, seq), torch.int32),
                "labels": TensorSpec((batch, seq), torch.int32)}
    if cfg.input_mode == "embeddings":
        return {"frame_embed": TensorSpec((batch, seq, d), dt),
                "labels": TensorSpec((batch, seq, cfg.n_codebooks),
                                     torch.int32)}
    if cfg.input_mode == "vlm":
        s_txt = seq if isinstance(seq, SymDim) \
            else max(seq - cfg.vis_tokens, 8)
        return {"vis_embed": TensorSpec((batch, cfg.vis_tokens, d), dt),
                "tokens": TensorSpec((batch, s_txt), torch.int32),
                "labels": TensorSpec((batch, s_txt), torch.int32)}
    raise ValueError(cfg.input_mode)


def decode_input_specs(cfg: ModelConfig, batch: Any) -> Dict[str, TensorSpec]:
    """One decode step's input: a token (B, 1), or a frame (B, 1, D).  The
    cache is the step's state, not its input, so a latent (MLA) cache
    changes nothing here."""
    if cfg.input_mode in ("tokens", "vlm"):
        return {"token": TensorSpec((batch, 1), torch.int32)}
    return {"frame_embed": TensorSpec((batch, 1, cfg.d_model),
                                      cfg.torch_dtype)}


def cache_specs(cfg: ModelConfig, batch: Any, max_len: int) -> Any:
    """The ``TensorSpec`` pytree of ``init_cache(cfg, batch, max_len)``
    (``repro/launch/specs.py:54-55``, which takes ``eval_shape`` of it):
    the same ``DecodeState`` with its ``None``s, every leaf batch-major
    with ``batch`` (an int or a ``SymDim``) as its first dim, and each
    layer's ``length`` an int32 scalar.  Built on the meta device, so
    nothing is allocated."""
    state = init_cache(cfg, 1, max_len, device="meta")
    return pytree.tree_map_only(
        torch.Tensor, lambda t: TensorSpec(
            (batch, *t.shape[1:]) if t.dim() else (), t.dtype), state)


def params_specs(cfg: ModelConfig) -> Any:
    """The ``TensorSpec`` pytree of ``init_params(cfg)``: the reference's
    layout with its layer stacks split into per-layer lists."""
    return spec_like(init_params(cfg, 0, device="meta"))


def opt_specs(cfg: ModelConfig, p_specs: Any) -> Any:
    """The ``AdamWState`` of ``p_specs``' parameters: an int32 step and
    ``m``/``v`` laid out as the parameters, in the config's optimizer
    dtype."""
    meta = pytree.tree_map_only(
        TensorSpec, lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), p_specs)
    return spec_like(init_state(meta, adamw_config_for(cfg)))


def input_specs(cfg: ModelConfig, shape_name: str
                ) -> Tuple[str, Dict[str, Any]]:
    """``(kind, specs)`` of the dry-run cell ``shape_name``: ``train``
    takes ``params``, ``opt_state`` and ``batch``; ``prefill`` ``params``
    and the batch without its labels; ``decode`` ``params``, ``state``
    (the cache of ``seq_len`` rows) and ``inp``."""
    spec = SHAPES[shape_name]
    kind = spec["kind"]
    b, s = spec["global_batch"], spec["seq_len"]
    p = params_specs(cfg)
    if kind == "train":
        return "train", {"params": p, "opt_state": opt_specs(cfg, p),
                         "batch": batch_specs(cfg, b, s)}
    if kind == "prefill":
        batch = dict(batch_specs(cfg, b, s))
        batch.pop("labels", None)
        return "prefill", {"params": p, "batch": batch}
    if kind == "decode":
        return "decode", {"params": p, "state": cache_specs(cfg, b, s),
                          "inp": decode_input_specs(cfg, b)}
    raise ValueError(kind)
