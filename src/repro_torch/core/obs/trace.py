"""Compile-time tracing: hierarchical spans + a structured decision log.

A copy of ``repro/core/obs/trace.py`` (it imports no framework).  The
pipeline phases (trace, schedule, remat search, memory planning, peak
bounds, lowering, per-bucket specialization) each run under a
:meth:`Tracer.span` context.  Spans nest through a *thread-local* stack,
so a background-specialize worker's compile becomes its own root span
(tagged with the worker's thread id) instead of corrupting the main
thread's tree — Chrome trace viewers render the two as separate tracks.

Tracing is always on at compile time: a compile emits a handful of spans,
so the cost is nanoseconds against a pipeline that runs milliseconds.
The *runtime* hot path is a different story and never touches this module
(see :mod:`.telemetry` for the per-call ring buffer and its overhead
contract).

``DecisionLog`` records the compile decisions that are only observable
*while* they happen — exchange-pass swaps, the schedule guard's
keep-or-revert choice, incremental bucket reuse.  Decisions that are
fully recoverable from the finished plan (per-candidate remat methods,
per-slot reuse) are derived on demand by :mod:`.explain` instead of being
duplicated here.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional


@dataclass
class Span:
    """One timed phase: ``[t0_ns, t1_ns]`` plus structured attributes."""

    name: str
    t0_ns: int
    t1_ns: Optional[int] = None
    attrs: Dict[str, Any] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)
    tid: int = 0                       # thread ident (Chrome trace track)
    thread_name: str = ""

    @property
    def duration_ns(self) -> int:
        return 0 if self.t1_ns is None else self.t1_ns - self.t0_ns

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, {self.duration_ns / 1e6:.2f}ms, "
                f"{len(self.children)} children)")


class Tracer:
    """Span sink for one ``optimize`` call and everything it compiles.

    ``span(name, **attrs)`` is a context manager; spans opened while
    another span is open on the *same thread* nest under it.  Root
    appends are lock-protected so background specialization workers and
    the dispatch thread can record concurrently; ``max_roots`` bounds
    memory on long-lived functions whose buckets recompile after LRU
    eviction (oldest roots drop first).
    """

    def __init__(self, max_roots: int = 256):
        self.roots: List[Span] = []
        self.max_roots = max_roots
        self._lock = threading.Lock()
        self._tls = threading.local()

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextmanager
    def span(self, name: str, **attrs):
        th = threading.current_thread()
        s = Span(name=name, t0_ns=time.perf_counter_ns(), attrs=dict(attrs),
                 tid=th.ident or 0, thread_name=th.name)
        stack = self._stack()
        if stack:
            stack[-1].children.append(s)
        else:
            with self._lock:
                self.roots.append(s)
                if len(self.roots) > self.max_roots:
                    del self.roots[:len(self.roots) - self.max_roots]
        stack.append(s)
        try:
            yield s
        finally:
            s.t1_ns = time.perf_counter_ns()
            stack.pop()

    def spans(self) -> List[Span]:
        """Flat list of every recorded span (depth-first, roots in order)."""
        with self._lock:
            roots = list(self.roots)
        return [s for r in roots for s in r.walk()]

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans() if s.name == name]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Tracer({len(self.roots)} roots, {len(self.spans())} spans)"


class _NullSpan:
    """Absorbs attribute writes from instrumented code under NullTracer."""

    __slots__ = ("attrs",)

    def __init__(self):
        self.attrs: Dict[str, Any] = {}


class NullTracer:
    """No-op tracer: ``span()`` yields a throwaway span, records nothing.

    Used by pipeline entry points called without an ``optimize`` context
    (direct ``_compile_pipeline`` use in tests/benchmarks), so the
    instrumentation never needs ``if tracer`` guards."""

    @contextmanager
    def span(self, name: str, **attrs):
        yield _NullSpan()

    def spans(self) -> List[Span]:
        return []

    def find(self, name: str) -> List[Span]:
        return []


NULL_TRACER = NullTracer()


@dataclass(frozen=True)
class Decision:
    """One recorded compile decision.

    ``kind`` is a small vocabulary (``schedule-guard``, ``exchange-swap``,
    ``bucket-reuse``, ...); ``subject`` names what was decided about;
    ``choice`` what was picked; ``why`` the symbolic / measured
    justification; ``detail`` structured extras (peaks, keys, exprs as
    strings)."""

    kind: str
    subject: str
    choice: str
    why: str
    detail: Dict[str, Any] = field(default_factory=dict)


class DecisionLog:
    """Append-only, thread-safe, bounded decision record."""

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._entries: List[Decision] = []
        self._lock = threading.Lock()

    def add(self, kind: str, subject: str, choice: str, why: str,
            **detail) -> None:
        with self._lock:
            self._entries.append(Decision(kind, subject, choice, why, detail))
            if len(self._entries) > self.max_entries:
                del self._entries[:len(self._entries) - self.max_entries]

    def entries(self, kind: Optional[str] = None) -> List[Decision]:
        with self._lock:
            out = list(self._entries)
        if kind is not None:
            out = [d for d in out if d.kind == kind]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DecisionLog({len(self)} entries)"
