"""Per-bucket circuit breaker for background specialization.

A bucket whose specialization compile fails (or times out) must not be
retried on every miss — that burns a core re-running a deterministic
failure — nor abandoned forever — a transient failure (OOM on the
compile host, a flaky dependency) would permanently cost the bucket its
specialized plan.  The breaker implements the standard three states:

* **closed** — healthy; compiles proceed normally.
* **open** — ``failure_threshold`` consecutive failures tripped it; no
  compile is attempted until the backoff deadline.  The whole-range
  fallback keeps serving the bucket's traffic (bitwise-identical
  results — it is the plan a bucket-less deployment would run).
* **half-open** — the backoff elapsed; exactly one probe compile is
  allowed through.  Success closes the breaker (the specialized plan
  swaps in); failure re-opens it with the backoff doubled (capped).

``allow(key)`` is the single gate: it performs the open → half-open
transition on its own clock and returns whether a compile may start
now.  The clock is injectable so tests drive transitions
deterministically.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

BucketKey = Tuple[int, ...]


class BucketQuarantined(RuntimeError):
    """A synchronous touch hit a quarantined bucket (breaker open)."""

    def __init__(self, key: BucketKey, cause: Optional[BaseException],
                 retry_in_s: float):
        super().__init__(
            f"bucket {key} is quarantined after a specialization failure "
            f"({cause!r}); re-probe in {retry_in_s:.3f}s")
        self.key = key
        self.cause = cause
        self.retry_in_s = retry_in_s


@dataclass
class BreakerConfig:
    failure_threshold: int = 1      # consecutive failures that trip it
    backoff_s: float = 0.05         # first quarantine window
    backoff_factor: float = 2.0     # growth per consecutive re-open
    max_backoff_s: float = 5.0

    def __post_init__(self) -> None:
        if self.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if self.backoff_s < 0 or self.max_backoff_s < self.backoff_s:
            raise ValueError("need 0 <= backoff_s <= max_backoff_s")


class _Entry:
    __slots__ = ("state", "failures", "opens", "retry_at", "cause",
                 "probing")

    def __init__(self) -> None:
        self.state = "closed"
        self.failures = 0       # consecutive failures while closed
        self.opens = 0          # consecutive open episodes (backoff exponent)
        self.retry_at = 0.0
        self.cause: Optional[BaseException] = None
        self.probing = False    # a half-open probe is in flight


class CircuitBreaker:
    """Thread-safe per-key circuit breaker with exponential backoff."""

    def __init__(self, config: Optional[BreakerConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config if config is not None else BreakerConfig()
        self.clock = clock
        self._lock = threading.Lock()
        self._entries: Dict[BucketKey, _Entry] = {}
        # bounded transition log (observability: explain(), tests)
        self.transitions: List[Dict[str, Any]] = []
        self._max_transitions = 256

    def _log(self, key: BucketKey, state: str, **detail: Any) -> None:
        self.transitions.append({"key": key, "state": state,
                                 "t": self.clock(), **detail})
        if len(self.transitions) > self._max_transitions:
            del self.transitions[:len(self.transitions)
                                 - self._max_transitions]

    # -- the gate --------------------------------------------------------------
    def allow(self, key: BucketKey) -> bool:
        """May a compile for ``key`` start now?  Performs the
        open → half-open transition when the backoff has elapsed, and
        admits exactly one probe while half-open."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.state == "closed":
                return True
            if e.state == "open":
                if self.clock() < e.retry_at:
                    return False
                e.state = "half-open"
                e.probing = True
                self._log(key, "half-open")
                return True
            # half-open: one probe at a time
            if e.probing:
                return False
            e.probing = True
            return True

    # -- outcomes --------------------------------------------------------------
    def record_failure(self, key: BucketKey, exc: BaseException) -> None:
        with self._lock:
            e = self._entries.setdefault(key, _Entry())
            e.cause = exc
            e.probing = False
            if e.state == "closed":
                e.failures += 1
                if e.failures < self.config.failure_threshold:
                    return
            # trip (or re-trip after a failed probe): backoff grows with
            # every consecutive open episode
            backoff = min(
                self.config.backoff_s
                * (self.config.backoff_factor ** e.opens),
                self.config.max_backoff_s)
            e.opens += 1
            e.failures = 0
            e.state = "open"
            e.retry_at = self.clock() + backoff
            self._log(key, "open", backoff_s=backoff, cause=repr(exc))

    def record_success(self, key: BucketKey) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return
            was = e.state
            e.state = "closed"
            e.failures = 0
            e.opens = 0
            e.probing = False
            e.cause = None
            if was != "closed":
                self._log(key, "closed")

    # -- introspection ---------------------------------------------------------
    def state(self, key: BucketKey) -> str:
        with self._lock:
            e = self._entries.get(key)
            return "closed" if e is None else e.state

    def cause(self, key: BucketKey) -> Optional[BaseException]:
        with self._lock:
            e = self._entries.get(key)
            return None if e is None else e.cause

    def retry_in_s(self, key: BucketKey) -> float:
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.state != "open":
                return 0.0
            return max(0.0, e.retry_at - self.clock())

    def quarantined_keys(self) -> List[BucketKey]:
        with self._lock:
            return [k for k, e in self._entries.items()
                    if e.state != "closed"]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            by_state: Dict[str, int] = {}
            for e in self._entries.values():
                by_state[e.state] = by_state.get(e.state, 0) + 1
            return {"tracked": len(self._entries),
                    "by_state": by_state,
                    "transitions": len(self.transitions)}
