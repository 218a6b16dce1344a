"""Runtime telemetry: a per-call ring buffer with a strict overhead budget.

Port of ``repro/core/obs/telemetry.py``.  The contract, enforced by
``tests/test_torch_obs.py`` and phase 10 of ``chip_smoke.py``: with
telemetry *disabled* the dispatch hot path pays one attribute load and an
``is None`` test — no allocation, no locking, no dict probe — on both
dispatch branches (unbucketed and bucketed), and that check costs at most
2% of a host-bound call.  With telemetry *enabled*, each call appends one
:class:`CallRecord` to a fixed-capacity ring.

The ring takes one mutex per push: a serving deployment drives a single
``DynamicShapeFunction`` from many request threads, so the write index
must move atomically or concurrent pushes overwrite one slot and
double-count another.  The lock lives on the *enabled* path only — the
disabled path never reaches it — and is uncontended in single-threaded
use.  Readers (``records()``) snapshot under the same lock; slots are
replaced wholesale, so a reader can never observe a partial record.

``CallRecord.wall_s`` is host time: on a CUDA device the ops are queued
asynchronously and the call returns before the card has finished, so it
measures how long the host took to queue the call, not the card's work (the
call path adds no ``synchronize()`` for it).

Per-instruction memory timelines are *not* sampled by instrumenting the
VM fast stream — that would put a branch in the hottest loop.  Because
the fast stream's memory traffic is fully determined by the env (the
``Program.resolve`` replay fact), an enabled sampler reconstructs the
exact timeline off the hot path via :func:`.timeline.actual_timeline`
every ``sample_timeline_every``-th call.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple


class CallRecord(NamedTuple):
    """One dispatched call, as the ring stores it (flat, allocation-light)."""

    seq: int                            # 0-based call number
    bucket_key: Optional[Tuple]         # specialization bucket; None = unbucketed
    env: Tuple[Tuple[str, int], ...]    # sorted dim binding
    wall_s: float                       # host seconds (see module doc)
    dispatch_ns: int                    # this call's dispatch overhead
    device_peak: int
    arena_bytes: int
    evictions: int
    recomputes: int
    reloads: int
    donated_reuses: int
    loop_trips: Tuple[int, ...]         # per rolled loop, program order


class TelemetryRing:
    """Fixed-capacity ring of :class:`CallRecord` (thread-safe)."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = capacity
        self._slots: List[Optional[CallRecord]] = [None] * capacity
        self._count = 0                 # monotonic; next write position
        self._lock = threading.Lock()

    def push(self, rec: CallRecord) -> None:
        with self._lock:
            self._slots[self._count % self.capacity] = rec
            self._count += 1

    def __len__(self) -> int:
        return min(self._count, self.capacity)

    @property
    def total_pushed(self) -> int:
        return self._count

    @property
    def dropped(self) -> int:
        """Records overwritten because the ring wrapped."""
        return max(0, self._count - self.capacity)

    def records(self) -> List[CallRecord]:
        """Oldest-to-newest snapshot of the retained records."""
        with self._lock:
            n, cap = self._count, self.capacity
            if n <= cap:
                return [r for r in self._slots[:n] if r is not None]
            start = n % cap
            out = self._slots[start:] + self._slots[:start]
            return [r for r in out if r is not None]


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


class Telemetry:
    """Per-function telemetry aggregate: ring + running totals + sampled
    timelines.  Created by ``DynamicShapeFunction.enable_telemetry()``.
    Counter updates are lock-protected — concurrent request threads must
    not lose increments (the lock is on the enabled path only)."""

    def __init__(self, capacity: int = 256, sample_timeline_every: int = 0,
                 max_timelines: int = 8):
        self.ring = TelemetryRing(capacity)
        self.sample_timeline_every = sample_timeline_every
        self.max_timelines = max_timelines
        self.n_calls = 0
        self.wall_s_total = 0.0
        self.dispatch_ns_total = 0
        self.calls_by_bucket: Dict[Optional[Tuple], int] = {}
        # (seq, timeline) pairs, newest kept; see .timeline.actual_timeline
        self.timelines: List[Tuple[int, Any]] = []
        self._lock = threading.Lock()

    def on_call(self, bucket_key: Optional[Tuple], report: Any, *,
                program: Any = None,
                loop_trips: Tuple[int, ...] = ()) -> None:
        """Record one dispatched call.  Runs only when telemetry is
        enabled — the disabled path never reaches this method."""
        st = report.stats
        with self._lock:
            seq = self.n_calls
            self.n_calls += 1
            self.wall_s_total += report.wall_s
            self.dispatch_ns_total += st.last_dispatch_ns
            self.calls_by_bucket[bucket_key] = \
                self.calls_by_bucket.get(bucket_key, 0) + 1
        self.ring.push(CallRecord(
            seq=seq, bucket_key=bucket_key,
            env=tuple(sorted(report.env.items())),
            wall_s=report.wall_s, dispatch_ns=st.last_dispatch_ns,
            device_peak=st.device_peak, arena_bytes=st.arena_bytes,
            evictions=st.evictions, recomputes=st.recomputes,
            reloads=st.reloads, donated_reuses=st.donated_reuses,
            loop_trips=loop_trips))
        every = self.sample_timeline_every
        if every and program is not None and seq % every == 0:
            from .timeline import actual_timeline
            self.timelines.append((seq, actual_timeline(program, report.env)))
            if len(self.timelines) > self.max_timelines:
                del self.timelines[:len(self.timelines) - self.max_timelines]

    def summary(self) -> Dict[str, Any]:
        return dict(
            n_calls=self.n_calls,
            wall_s_total=self.wall_s_total,
            dispatch_ns_total=self.dispatch_ns_total,
            ring_retained=len(self.ring),
            ring_dropped=self.ring.dropped,
            calls_by_bucket={str(k): v
                             for k, v in self.calls_by_bucket.items()},
            timelines_sampled=len(self.timelines))
