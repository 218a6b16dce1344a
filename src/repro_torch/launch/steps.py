"""Step functions driven by ``optimize`` (the serving prefill step)."""
from __future__ import annotations

from typing import Optional

from ..configs.base import ModelConfig
from ..models import prefill as model_prefill


def make_prefill_step(cfg: ModelConfig, impl: Optional[str] = None):
    """``prefill_step(params, batch) -> (B, V)`` last-position logits.

    ``impl`` is passed to the kernel ops (``"ref"``: plain PyTorch)."""
    def prefill_step(params, batch):
        return model_prefill(cfg, params, batch, impl)
    return prefill_step
