"""Serving telemetry: the admission-control event of the bucket batcher.

The part of ``repro/core/obs/telemetry.py`` that the
:class:`~repro_torch.launch.serve.BucketBatcher` records.  The per-call
telemetry ring and its overhead contract come with the rest of the
observability layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class AdmissionEvent:
    """One admission-control decision by the serving batcher.

    ``outcome`` distinguishes what happened to the group/request:
    ``"held"`` (over-budget group deferred to a later drain),
    ``"shed-capacity"`` (queue full, request refused at submit),
    ``"shed-deadline"`` (request's deadline expired in queue),
    ``"shed-aged"`` (held group exceeded its max hold cycles)."""

    key: Tuple                          # bucket key (dim upper bounds)
    label: str                          # human-readable bucket label
    required_bytes: int                 # the group's arena_bound_bytes
    available_bytes: int                # the batcher's memory_budget
    queue_depth: int                    # requests held in this group
    outcome: str = "held"               # held | shed-capacity |
    #                                     shed-deadline | shed-aged
