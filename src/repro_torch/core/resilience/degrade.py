"""Structured request failures of the serving runtime.

The part of ``repro/core/resilience/degrade.py`` that the
:class:`~repro_torch.launch.serve.BucketBatcher` raises and catches:
:class:`RequestFailed` and :class:`RequestRejected`.  The degradation
ladder that records ``events`` comes with the rest of the resilience
layer; until then ``events`` stays empty.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple


class RequestFailed(RuntimeError):
    """A request the runtime could not serve.

    Structured: carries the dim binding, the bucket it dispatched to,
    how many attempts ran, the final cause, and the recorded
    degradation events — everything a serve loop needs to answer the
    client and everything an operator needs to debug."""

    def __init__(self, message: str, *,
                 env: Optional[Mapping[str, int]] = None,
                 bucket: Optional[Tuple[int, ...]] = None,
                 attempts: int = 0,
                 cause: Optional[BaseException] = None,
                 events: Tuple[Any, ...] = ()):
        super().__init__(message)
        self.env = dict(env) if env else None
        self.bucket = bucket
        self.attempts = attempts
        self.cause = cause
        self.events = events


class RequestRejected(RequestFailed):
    """A request shed at admission (queue full, deadline passed, group
    aged out) — it never reached an executor."""

    def __init__(self, message: str, *, reason: str = "shed", **kw: Any):
        super().__init__(message, **kw)
        self.reason = reason
