"""``TensorSpec`` stand-ins for a step's batch and a decode step's input.

Port of ``batch_specs`` and ``decode_input_specs`` of
``repro/launch/specs.py:19-41``: the batch a training or prefill step
takes, per input mode, and the one-token (or one-frame) input of a decode
step.  The specs take ints or ``SymDim``s, so they serve ``optimize``'s
symbolic capture as well as a concrete shape.  The rest of that module
(``params_specs``, ``opt_specs``, ``cache_specs``, ``input_specs`` for the
dry-run cells) is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig
from ..core.ir.capture import SymDim, TensorSpec


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
