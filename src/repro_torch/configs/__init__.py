"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``."""
from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, cells_for

ARCHS = ["llama2_1b", "gemma_2b", "gemma_7b", "granite_8b", "starcoder2_7b",
         "musicgen_medium", "internvl2_2b", "kimi_k2_1t_a32b",
         "deepseek_v3_671b", "hymba_1p5b", "xlstm_1p3b"]

# the reference's CLI names (``repro/configs/__init__.py``), every one a
# config of the ARCHS above
_ALIASES = {
    "hymba-1.5b": "hymba_1p5b", "internvl2-2b": "internvl2_2b",
    "musicgen-medium": "musicgen_medium", "starcoder2-7b": "starcoder2_7b",
    "granite-8b": "granite_8b", "gemma-7b": "gemma_7b", "gemma-2b": "gemma_2b",
    "deepseek-v3-671b": "deepseek_v3_671b", "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "xlstm-1.3b": "xlstm_1p3b", "llama2-1b": "llama2_1b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def get_config(name: str) -> ModelConfig:
    return importlib.import_module(f".{canonical(name)}", __package__).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return importlib.import_module(f".{canonical(name)}", __package__).SMOKE


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "canonical", "cells_for",
           "get_config", "get_smoke_config"]
