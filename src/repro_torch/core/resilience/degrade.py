"""Graceful degradation ladder: bounded retries, backoff, structured errors.

A copy of ``repro/core/resilience/degrade.py``; on the card the
memory-pressure rung also takes ``torch.cuda.OutOfMemoryError`` (see
``DynamicShapeFunction._call_resilient``).

The ladder the resilient call path walks when a request fails at
runtime (``DynamicShapeFunction._call_resilient``):

1. **evict** — already built in: ``MemoryManager.ensure`` runs the remat
   eviction policy *inside* the failing call before any exception
   escapes.  A ``MemoryLimitExceeded`` reaching the ladder means
   eviction could not free enough.
2. **retry-transient** — transient kernel / regen / offload failures
   retry the call on the *same* plan after an exponential backoff.
3. **retry-fallback** — memory-pressure failures (``MemoryLimitExceeded``,
   ``ArenaExhausted``, a real ``torch.cuda.OutOfMemoryError``) and
   quarantined or failed bucket compiles retry on the remat-heavier
   whole-range fallback plan, which trades recompute for a smaller
   guaranteed arena bound and produces bitwise-identical outputs.
4. **reject** — retries exhausted: a structured :class:`RequestFailed`
   carrying the env, bucket, attempt count, final cause, and every
   :class:`DegradationEvent` recorded along the way.

Malformed requests short-circuit to ``reject-malformed`` — a client
error is not retried.

Every rung is recorded by the :class:`ResilienceController`: a bounded
event deque, monotonic counters (exported via Prometheus), and a
DecisionLog entry (kind ``degrade``) so ``explain()`` shows the failure
history next to the compile decisions.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Deque, Dict, Mapping, Optional, Tuple)

from .quarantine import BreakerConfig


@dataclass
class RetryPolicy:
    """Bounded retries with exponential backoff."""

    max_retries: int = 2
    backoff_base_s: float = 0.001
    backoff_factor: float = 2.0

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry ``attempt + 1`` (0-based failed attempt)."""
        return self.backoff_base_s * (self.backoff_factor ** attempt)


@dataclass
class ResilienceConfig:
    """Knobs of the resilient call path (``optimize(..., resilience=)``).

    ``enforce_arena_bound=True`` turns the plan's guaranteed
    ``arena_bound_bytes`` into a runtime hard cap: an execution whose
    arena would exceed it raises ``ArenaExhausted`` (caught by the
    ladder as memory pressure) instead of silently growing past the
    guarantee.  ``compile_timeout_s`` quarantines bucket compiles that
    run longer than the deadline."""

    retry: RetryPolicy = field(default_factory=RetryPolicy)
    breaker: BreakerConfig = field(default_factory=BreakerConfig)
    enforce_arena_bound: bool = False
    compile_timeout_s: Optional[float] = None
    max_events: int = 256


@dataclass(frozen=True)
class DegradationEvent:
    """One rung of the ladder, as recorded: what degraded, why, and what
    happens next."""

    seq: int                     # resilient-call ordinal
    rung: str                    # retry-transient | retry-fallback |
    #                              reject | reject-malformed
    attempt: int                 # 0-based attempt that failed
    cause: str                   # repr of the triggering exception
    backoff_s: float = 0.0       # sleep before the retry (0 for reject)
    bucket: Optional[Tuple[int, ...]] = None


class RequestFailed(RuntimeError):
    """A request the runtime could not serve after walking the ladder.

    Structured: carries the dim binding, the bucket it dispatched to,
    how many attempts ran, the final cause, and the recorded
    degradation events — everything a serve loop needs to answer the
    client and everything an operator needs to debug."""

    def __init__(self, message: str, *,
                 env: Optional[Mapping[str, int]] = None,
                 bucket: Optional[Tuple[int, ...]] = None,
                 attempts: int = 0,
                 cause: Optional[BaseException] = None,
                 events: Tuple[DegradationEvent, ...] = ()):
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


class ResilienceController:
    """Per-function resilience state: ladder policy, fault plan, events.

    Attached by ``optimize(..., resilience=/fault_plan=)`` or
    ``fn.enable_resilience()``; the disabled hot path never touches it
    (one attribute load + ``is None`` test, the telemetry discipline).
    Thread-safe: the chaos suite drives one function from many threads.
    """

    def __init__(self, config: Optional[ResilienceConfig] = None, *,
                 fault_ref: Any = None, decisions: Any = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.config = config if config is not None else ResilienceConfig()
        self._fault_ref = fault_ref
        self.decisions = decisions
        self.sleep = sleep
        self._lock = threading.Lock()
        self._seq = 0
        self.events: Deque[DegradationEvent] = deque(
            maxlen=self.config.max_events)
        # monotonic counters (Prometheus)
        self.calls = 0
        self.degraded_calls = 0          # calls that recorded >= 1 rung
        self.retries_transient = 0
        self.retries_fallback = 0
        self.failures = 0                # RequestFailed raised
        self.malformed = 0

    @property
    def fault_plan(self):
        return None if self._fault_ref is None else self._fault_ref.plan

    def begin_call(self) -> int:
        with self._lock:
            seq = self._seq
            self._seq += 1
            self.calls += 1
        return seq

    def record(self, rung: str, *, seq: int, attempt: int,
               cause: BaseException | str, backoff_s: float = 0.0,
               bucket: Optional[Tuple[int, ...]] = None) -> DegradationEvent:
        """Record one ladder rung: event deque + counters + DecisionLog."""
        ev = DegradationEvent(seq=seq, rung=rung, attempt=attempt,
                              cause=cause if isinstance(cause, str)
                              else repr(cause),
                              backoff_s=backoff_s, bucket=bucket)
        with self._lock:
            self.events.append(ev)
            if rung == "retry-transient":
                self.retries_transient += 1
            elif rung == "retry-fallback":
                self.retries_fallback += 1
            elif rung == "reject":
                self.failures += 1
            elif rung == "reject-malformed":
                self.failures += 1
                self.malformed += 1
        if self.decisions is not None:
            self.decisions.add(
                "degrade", f"call {seq}", rung, ev.cause,
                attempt=attempt, backoff_s=backoff_s, bucket=bucket)
        return ev

    def note_degraded_call(self) -> None:
        with self._lock:
            self.degraded_calls += 1

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"calls": self.calls,
                    "degraded_calls": self.degraded_calls,
                    "retries_transient": self.retries_transient,
                    "retries_fallback": self.retries_fallback,
                    "failures": self.failures,
                    "malformed": self.malformed}
