"""Deterministic fault injection for the serving runtime (PyTorch port).

A copy of ``repro/core/resilience/faults.py``.

A :class:`FaultPlan` is a seeded schedule of :class:`FaultSpec`\\ s.  Each
spec names a *kind*, where it fires (call ordinal + step within the
call, or a bucket key for compile faults), and how many times.  The plan
is installed through ``optimize(..., fault_plan=...)`` or the
``DynamicShapeFunction.inject_faults`` context manager; executors see it
as a per-call :class:`CallFaults` probe object passed down ``run(...,
faults=)`` — ``None`` (the overwhelmingly common case) keeps every hot
loop on its uninstrumented branch.

Every fault that actually fires is appended to ``FaultPlan.fired`` — the
chaos suite cross-references this record against the structured
degradation events and request errors to prove *no injected fault
disappears silently*.

Fault kinds
-----------

``alloc``            the k-th device allocation of the call raises
                     :class:`InjectedAllocFailure` (a
                     ``MemoryLimitExceeded`` — the ladder treats it as
                     memory pressure the bound did not cover)
``kernel``           the k-th compute of the call raises
                     :class:`TransientKernelError` (retryable in place)
``regen``            the k-th remat restore/reload raises
                     :class:`RegenFailure`
``offload``          the k-th eviction-to-host raises
                     :class:`OffloadFailure`
``malformed-env``    the call is treated as a garbage client request:
                     rejected structurally before dispatch, no retry
``compile``          a bucket specialization raises
                     :class:`CompileFault` (quarantines the bucket)
``compile-timeout``  the compile sleeps ``delay_s`` then raises
                     :class:`CompileTimeout` (a hung compile, detected
                     and quarantined)
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..executor.memory import MemoryLimitExceeded

FAULT_KINDS = ("alloc", "kernel", "regen", "offload", "malformed-env",
               "compile", "compile-timeout")
_RUNTIME_KINDS = ("alloc", "kernel", "regen", "offload", "malformed-env")
_MEMORY_KINDS = ("alloc", "regen", "offload")


# -- exceptions ----------------------------------------------------------------

class FaultError(RuntimeError):
    """Base of every injected failure (carries the spec that fired)."""

    def __init__(self, message: str, spec: Optional["FaultSpec"] = None):
        super().__init__(message)
        self.spec = spec


class TransientKernelError(FaultError):
    """A kernel launch failed transiently; a retry may succeed."""


class InjectedAllocFailure(MemoryLimitExceeded, FaultError):
    """An allocation the guaranteed bound was supposed to cover failed.

    Subclasses :class:`MemoryLimitExceeded` so the degradation ladder
    (and any existing handler) sees exactly the memory-pressure failure
    it would see from a real allocator."""

    def __init__(self, message: str, spec: Optional["FaultSpec"] = None):
        MemoryLimitExceeded.__init__(self, message)
        self.spec = spec


class RegenFailure(FaultError):
    """Rematerialization (recompute restore or host reload) failed."""


class OffloadFailure(FaultError):
    """Eviction-to-host (D2H offload) failed."""


class CompileFault(FaultError):
    """A bucket specialization pipeline raised."""


class CompileTimeout(CompileFault):
    """A bucket specialization exceeded its compile deadline."""


_EXC_BY_KIND = {
    "alloc": InjectedAllocFailure,
    "kernel": TransientKernelError,
    "regen": RegenFailure,
    "offload": OffloadFailure,
    "compile": CompileFault,
    "compile-timeout": CompileTimeout,
}


# -- the schedule --------------------------------------------------------------

@dataclass
class FaultSpec:
    """One scheduled fault.

    ``call`` is the 0-based resilient-call ordinal the fault belongs to
    (``None``: any call).  ``step`` is the ordinal *within* the call —
    the k-th compute for ``kernel``, the k-th matching memory event for
    the memory kinds.  ``bucket`` targets compile faults at one bucket
    key (``None``: the next bucket that compiles).  ``times`` is how
    many firings the spec carries; ``delay_s`` is the injected hang of a
    ``compile-timeout``.
    """

    kind: str
    call: Optional[int] = None
    step: int = 0
    bucket: Optional[Tuple[int, ...]] = None
    times: int = 1
    delay_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (known: {FAULT_KINDS})")
        if self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")


@dataclass(frozen=True)
class FiredFault:
    """One fault that actually fired (the injection audit record)."""

    kind: str
    call: Optional[int]                # call ordinal it fired on (None: compile)
    step: int                          # step ordinal it fired at
    bucket: Optional[Tuple[int, ...]]  # bucket key (compile kinds)
    seq: int                           # firing order across the plan


class _Live:
    """A spec plus its remaining firing budget."""

    __slots__ = ("spec", "remaining")

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.remaining = spec.times


class FaultPlan:
    """A seeded, deterministic schedule of faults.

    Thread-safe: compile faults fire from the background specialize
    worker while runtime faults fire on request threads.  ``fired``
    records every firing in order; ``remaining()`` reports the budget
    still unspent (zero means the schedule is exhausted and the system
    should have fully recovered)."""

    def __init__(self, specs: Sequence[FaultSpec] = (),
                 seed: Optional[int] = None):
        self.seed = seed
        self._lock = threading.Lock()
        self._live: List[_Live] = [_Live(s) for s in specs]
        self.fired: List[FiredFault] = []

    @property
    def specs(self) -> List[FaultSpec]:
        return [l.spec for l in self._live]

    @classmethod
    def random(cls, seed: int, *, n_faults: int = 4,
               kinds: Sequence[str] = FAULT_KINDS,
               max_call: int = 8, max_step: int = 4,
               buckets: Optional[Sequence[Tuple[int, ...]]] = None,
               max_times: int = 2,
               timeout_delay_s: float = 0.02) -> "FaultPlan":
        """A reproducible random schedule: same seed, same faults."""
        rng = random.Random(seed)
        specs: List[FaultSpec] = []
        for _ in range(n_faults):
            kind = rng.choice(list(kinds))
            if kind in ("compile", "compile-timeout"):
                bucket = tuple(rng.choice(list(buckets))) if buckets else None
                specs.append(FaultSpec(
                    kind=kind, bucket=bucket,
                    times=rng.randint(1, max_times),
                    delay_s=timeout_delay_s if kind == "compile-timeout"
                    else 0.0))
            elif kind == "malformed-env":
                specs.append(FaultSpec(kind=kind,
                                       call=rng.randrange(max_call)))
            else:
                specs.append(FaultSpec(kind=kind,
                                       call=rng.randrange(max_call),
                                       step=rng.randrange(max_step),
                                       times=rng.randint(1, max_times)))
        return cls(specs, seed=seed)

    # -- bookkeeping -----------------------------------------------------------
    def remaining(self) -> int:
        """Total unspent firings across every spec."""
        with self._lock:
            return sum(l.remaining for l in self._live)

    def _fire(self, live: _Live, *, call: Optional[int], step: int,
              bucket: Optional[Tuple[int, ...]]) -> FaultSpec:
        """Consume one firing (caller must hold ``self._lock``)."""
        live.remaining -= 1
        self.fired.append(FiredFault(
            kind=live.spec.kind, call=call, step=step, bucket=bucket,
            seq=len(self.fired)))
        return live.spec

    # -- runtime faults --------------------------------------------------------
    def arm_call(self, call_idx: int) -> Optional["CallFaults"]:
        """The live runtime faults matching one call attempt.

        Returns ``None`` when nothing can fire — the executor then runs
        its completely uninstrumented path.  Re-arm per *attempt*: a
        spec spent on attempt 0 no longer matches on the retry, which is
        what lets a bounded-retry ladder actually recover."""
        with self._lock:
            matched = [l for l in self._live
                       if l.remaining > 0 and l.spec.kind in _RUNTIME_KINDS
                       and (l.spec.call is None or l.spec.call == call_idx)]
        if not matched:
            return None
        return CallFaults(self, call_idx, matched)

    # -- compile faults --------------------------------------------------------
    def check_compile(self, key: Optional[Tuple[int, ...]]) -> None:
        """Called at the top of a bucket specialization; raises the
        scheduled compile fault for ``key``, if any."""
        with self._lock:
            live = next(
                (l for l in self._live
                 if l.remaining > 0
                 and l.spec.kind in ("compile", "compile-timeout")
                 and (l.spec.bucket is None
                      or (key is not None
                          and tuple(l.spec.bucket) == tuple(key)))),
                None)
            if live is None:
                return
            spec = self._fire(live, call=None, step=0,
                              bucket=None if key is None else tuple(key))
        if spec.kind == "compile-timeout" and spec.delay_s > 0:
            time.sleep(spec.delay_s)   # a compile that hangs, then dies
        raise _EXC_BY_KIND[spec.kind](
            f"injected {spec.kind} fault for bucket {key}", spec)


class CallFaults:
    """Per-attempt fault probe an executor threads through one call.

    ``before_compute()`` runs ahead of every kernel bind;
    ``on_memory(event, vid, nbytes)`` is the :class:`MemoryManager`
    fault hook (events: ``alloc`` / ``offload`` / ``reload`` /
    ``restore``).  Counting is attempt-local, the firing budget is
    plan-global."""

    __slots__ = ("_plan", "_call", "_kernel", "_mem", "_malformed",
                 "_n_compute", "_mem_counts")

    def __init__(self, plan: FaultPlan, call_idx: int, live: List[_Live]):
        self._plan = plan
        self._call = call_idx
        self._kernel = [l for l in live if l.spec.kind == "kernel"]
        self._mem = [l for l in live if l.spec.kind in _MEMORY_KINDS]
        self._malformed = [l for l in live
                           if l.spec.kind == "malformed-env"]
        self._n_compute = 0
        self._mem_counts: Dict[str, int] = {}

    @property
    def needs_memory(self) -> bool:
        """True when a memory-kind fault is armed: the VM must take the
        dynamic stream (the fast stream performs no allocations)."""
        return bool(self._mem)

    def take_malformed(self) -> bool:
        """Consume an armed malformed-env fault (pre-dispatch)."""
        if not self._malformed:
            return False
        with self._plan._lock:
            for l in self._malformed:
                if l.remaining > 0:
                    self._plan._fire(l, call=self._call, step=0, bucket=None)
                    return True
        return False

    def before_compute(self) -> None:
        k = self._n_compute
        self._n_compute = k + 1
        for l in self._kernel:
            if l.spec.step == k:
                with self._plan._lock:
                    if l.remaining <= 0:
                        continue
                    spec = self._plan._fire(l, call=self._call, step=k,
                                            bucket=None)
                raise TransientKernelError(
                    f"injected kernel fault at call {self._call} "
                    f"compute {k}", spec)

    def on_memory(self, event: str, vid: int, nbytes: int) -> None:
        k = self._mem_counts.get(event, 0)
        self._mem_counts[event] = k + 1
        # restore and reload are both regeneration events
        kind = {"alloc": "alloc", "offload": "offload",
                "reload": "regen", "restore": "regen"}.get(event)
        if kind is None:
            return
        for l in self._mem:
            if l.spec.kind == kind and l.spec.step == k:
                with self._plan._lock:
                    if l.remaining <= 0:
                        continue
                    spec = self._plan._fire(l, call=self._call, step=k,
                                            bucket=None)
                raise _EXC_BY_KIND[kind](
                    f"injected {kind} fault at call {self._call} "
                    f"{event} #{k} (value {vid}, {nbytes} bytes)", spec)


class FaultPlanRef:
    """Shared mutable holder for the installed :class:`FaultPlan`.

    Created once per ``optimize`` and closed over by the bucket compile
    closure, so ``inject_faults`` can swap plans in and out after the
    table factory has already captured the reference."""

    __slots__ = ("plan",)

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan
