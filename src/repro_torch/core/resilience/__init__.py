"""Resilience of the serving runtime: what bucketed dispatch needs so far.

* :mod:`.quarantine` — the per-bucket circuit breaker that quarantines a
  bucket whose specialization compile failed or timed out, while the
  whole-range fallback keeps serving it;
* :mod:`.faults` — the compile-fault exceptions the breaker records;
* :mod:`.degrade` — the structured request failures the serving batcher
  raises.

Fault injection and the degradation ladder of the reference
(``repro/core/resilience``) are not ported yet.
"""
from .degrade import RequestFailed, RequestRejected
from .faults import CompileFault, CompileTimeout, FaultError
from .quarantine import BreakerConfig, BucketQuarantined, CircuitBreaker

__all__ = [
    "FaultError", "CompileFault", "CompileTimeout",
    "RequestFailed", "RequestRejected",
    "BreakerConfig", "CircuitBreaker", "BucketQuarantined",
]
