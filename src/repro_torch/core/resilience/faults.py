"""Compile-fault exceptions of the serving runtime.

The part of ``repro/core/resilience/faults.py`` that bucketed
specialization needs: :class:`FaultError` and the two compile failures a
:class:`~repro_torch.core.dispatch.SpecializationTable` records on its
circuit breaker.  The seeded fault plan and the runtime fault kinds come
with the rest of the resilience layer.
"""
from __future__ import annotations

from typing import Any, Optional


class FaultError(RuntimeError):
    """Base of every injected failure (carries the spec that fired)."""

    def __init__(self, message: str, spec: Optional[Any] = None):
        super().__init__(message)
        self.spec = spec


class CompileFault(FaultError):
    """A bucket specialization pipeline raised."""


class CompileTimeout(CompileFault):
    """A bucket specialization exceeded its compile deadline."""
