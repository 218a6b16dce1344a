"""Observability: what the serving batcher records so far.

:class:`AdmissionEvent` (:mod:`.telemetry`).  Compile tracing, the
decision log, per-call telemetry and the exports of the reference
(``repro/core/obs``) are not ported yet.
"""
from .telemetry import AdmissionEvent

__all__ = ["AdmissionEvent"]
