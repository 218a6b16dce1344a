"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``."""
from __future__ import annotations

import importlib

from .base import ModelConfig

ARCHS = ["llama2_1b"]


def get_config(name: str) -> ModelConfig:
    return importlib.import_module(f".{name}", __package__).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return importlib.import_module(f".{name}", __package__).SMOKE


__all__ = ["ARCHS", "ModelConfig", "get_config", "get_smoke_config"]
