"""Fault-tolerant serving runtime: injection, degradation, quarantine.

The port of ``repro/core/resilience``: three coordinated layers over the
serving path.

* :mod:`.faults` — deterministic, seeded fault injection.  A
  :class:`FaultPlan` schedules arena-allocation failures at step *k*,
  transient kernel failures, background-specialization compile
  exceptions/timeouts, regen/offload failures, and malformed request
  envs.  Installed via ``optimize(..., fault_plan=...)`` or the
  ``fn.inject_faults(plan)`` context manager; when absent the hot path
  pays exactly one attribute load + ``is None`` test (the same
  discipline as telemetry's disabled path).
* :mod:`.degrade` — the graceful degradation ladder on runtime memory
  pressure: the executor's eviction runs first (inside
  ``MemoryManager.ensure``); a call that still fails (``MemoryLimitExceeded``,
  ``ArenaExhausted``, or on the card a real ``torch.cuda.OutOfMemoryError``)
  retries on the remat-heavier whole-range fallback plan with bounded
  retries + exponential backoff; exhaustion raises a structured
  :class:`RequestFailed`.  Any other error propagates.  Every rung lands
  as a :class:`DegradationEvent` in the DecisionLog and the Prometheus
  export.
* :mod:`.quarantine` — a per-bucket circuit breaker for bucket
  specialization: compile failures and timeouts open the breaker
  (open → backoff → half-open re-probe) while the whole-range fallback
  keeps serving bitwise-identical results; a successful re-probe closes
  it and the specialized plan swaps back in.
"""
from .degrade import (DegradationEvent, RequestFailed, RequestRejected,
                      ResilienceConfig, ResilienceController, RetryPolicy)
from .faults import (FAULT_KINDS, CompileFault, CompileTimeout, FaultError,
                     FaultPlan, FaultPlanRef, FaultSpec, FiredFault,
                     InjectedAllocFailure, OffloadFailure, RegenFailure,
                     TransientKernelError)
from .quarantine import BreakerConfig, BucketQuarantined, CircuitBreaker

__all__ = [
    "FaultPlan", "FaultSpec", "FaultPlanRef", "FiredFault", "FAULT_KINDS",
    "FaultError", "TransientKernelError", "InjectedAllocFailure",
    "RegenFailure", "OffloadFailure", "CompileFault", "CompileTimeout",
    "RetryPolicy", "ResilienceConfig", "ResilienceController",
    "DegradationEvent", "RequestFailed", "RequestRejected",
    "BreakerConfig", "CircuitBreaker", "BucketQuarantined",
]
