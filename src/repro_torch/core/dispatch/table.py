"""Per-bucket plan cache (dispatch stage 2).

``SpecializationTable`` maps bucket keys to compiled :class:`BucketPlan`s —
each one a full schedule → remat → memplan pipeline run under the bucket's
tighter bound env, then **lowered** to a flat executable ``Program`` with
a ready ``ProgramVM`` (the reference interpreter under
``executor="reference"``).  Compilation is **lazy**: a bucket specializes
the first time traffic lands in it (or through an explicit synchronous
``warmup(envs)``), and the table retains at most ``max_live`` plans with
LRU eviction — an evicted bucket recompiles on its next use, it does not
error.  The hit path is a dict probe after the O(log n) per-dim key
lookup: it never re-runs scheduling, remat search, memory planning, or
lowering.

With ``background=True`` (``optimize(..., background_specialize=True)``)
a miss does not compile on the calling thread either: the request is
answered immediately with the **whole-range fallback plan** — valid for
every in-range env, it is the plan a bucket-less deployment would run —
while a single background worker compiles the bucket and atomically swaps
the finished :class:`BucketPlan` into the table.  Subsequent traffic in
that bucket hits the specialized plan.  ``warmup`` stays a synchronous,
deterministic join (it waits for in-flight compiles rather than starting
duplicates), and ``drain_background`` blocks until every in-flight
specialization lands — after it returns, ``specialize_count`` matches
what synchronous compilation would have produced.

Specialization failures are **quarantined**, not fatal: every compile —
sync, background, or recompile — runs under a per-bucket
:class:`~repro_torch.core.resilience.quarantine.CircuitBreaker`.  A failure
(or a compile exceeding ``compile_timeout_s``) opens the breaker for an
exponentially-backed-off window during which the bucket is not
recompiled; in background mode the whole-range fallback keeps serving
its traffic with bitwise-identical results, while synchronous touches
raise :class:`BucketQuarantined`.  When the window elapses, the next
miss becomes a single half-open probe compile — success swaps the
specialized plan in and closes the breaker, failure re-opens it with
the backoff doubled.  A transiently-faulty bucket therefore heals on
its own; a deterministically-broken one degrades to the fallback
instead of crashing the serve loop or burning a core on retries.

The table also answers ``arena_bound_bytes(key)`` — the bucket plan's
guaranteed worst-case arena size over the bucket's sub-ranges — which the
serving path uses for admission control by bucket (see
``repro_torch.launch.serve.BucketBatcher``).  In background mode an unknown
bound does not stall the caller: the whole-range bound (a sound guarantee
for *every* bucket) is returned while the exact bucket bound compiles in
the background.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor, wait as futures_wait
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple)

from ..resilience.faults import CompileTimeout
from ..resilience.quarantine import BucketQuarantined, CircuitBreaker
from ..symbolic.intervals import Interval
from .buckets import BucketSpace

BucketKey = Tuple[int, ...]

# Background-compile deferral: the pipeline is Python-heavy, so under the
# GIL a compile running concurrently with request execution inflates serve
# latency.  The worker waits for the dispatch path to go quiet (no request
# executing) before it starts, polling every _BACKGROUND_POLL_S, but never
# defers longer than _BACKGROUND_MAX_DEFER_S — a saturated server still
# gets its specializations.
_BACKGROUND_POLL_S = 0.005
_BACKGROUND_MAX_DEFER_S = 2.0


@dataclass
class BucketPlan:
    """One bucket's compiled artifact: plan + report + ready executor.

    With the default VM executor the table caches the *lowered* artifact,
    not just the plan: ``program`` is the bucket's flat instruction
    :class:`~repro_torch.core.lowering.Program` (``None`` under
    ``executor="reference"``) and ``interp`` is the runner bound to it —
    a ``ProgramVM``, or the reference ``PlanInterpreter``.  A dispatch
    hit therefore lands on an executable whose sizes/params/offsets
    resolve once per env, never on a plan that re-derives them per op.

    ``key is None`` marks the whole-range *fallback* plan a background
    table serves on a miss while the bucket compiles."""

    key: Optional[BucketKey]
    ranges: Dict[str, Interval]       # the sub-ranges this plan assumes
    plan: Any                         # ExecutionPlan
    report: Any                       # OptimizeReport for this bucket
    interp: Any                       # ProgramVM / PlanInterpreter runner
    program: Any = None               # lowered Program (VM executor only)

    @property
    def arena_bound_bytes(self) -> Optional[int]:
        return self.report.arena_bound_bytes

    @property
    def n_instructions(self) -> Optional[int]:
        """Instruction count of the lowered Program (observability)."""
        return None if self.program is None else self.program.n_instructions


class SpecializationTable:
    """Lazy bucket-key -> BucketPlan cache with LRU retention.

    ``compile_fn(key, ranges)`` runs the full pipeline for one bucket and
    returns a :class:`BucketPlan`; the table owns laziness, retention, and
    the dispatch counters (``hits``/``misses``/``specialize_count``/
    ``evictions``).  ``specialize_count`` counts *compilations* — it grows
    on first use and on recompilation after LRU eviction, never on a hit.

    All bookkeeping is lock-protected so a background worker can install
    plans while the dispatch path reads; compilations themselves are
    serialized through a dedicated lock (the pipeline mutates shared
    ShapeGraph memo tables).
    """

    def __init__(self, space: BucketSpace,
                 compile_fn: Callable[[BucketKey, Dict[str, Interval]],
                                      BucketPlan],
                 *, max_live: int = 16,
                 background: bool = False,
                 fallback: Optional[BucketPlan] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 compile_timeout_s: Optional[float] = None):
        if max_live < 1:
            raise ValueError(f"max_live must be >= 1, got {max_live}")
        if background and fallback is None:
            raise ValueError(
                "background=True requires a whole-range fallback plan")
        self.space = space
        self.max_live = max_live
        self._compile_fn = compile_fn
        self._plans: "OrderedDict[BucketKey, BucketPlan]" = OrderedDict()
        # bounds survive plan eviction: once a bucket has compiled, its
        # guaranteed arena bound is a fact about the bucket, not the cache —
        # admission control must not recompile (or evict a hot plan) to
        # re-learn it
        self._bounds: Dict[BucketKey, Optional[int]] = {}
        self.hits = 0
        self.misses = 0
        self.specialize_count = 0
        self.evictions = 0
        # per-bucket dispatch distribution (observability: Prometheus
        # gauges, explain()); keys accumulate forever like _bounds
        self.hits_by_key: Dict[BucketKey, int] = {}
        self.misses_by_key: Dict[BucketKey, int] = {}
        # background specialization
        self.background = background
        self.fallback = fallback
        self.fallback_serves = 0          # misses answered by the fallback
        self._lock = threading.RLock()    # table bookkeeping
        self._compile_lock = threading.Lock()  # serializes pipeline runs
        self._pool: Optional[ThreadPoolExecutor] = None
        self._inflight: Dict[BucketKey, Future] = {}
        # buckets whose compile raised (or timed out) are *quarantined*
        # behind a circuit breaker rather than failed forever: the breaker
        # opens on failure, the fallback keeps serving the bucket's
        # traffic, and after an exponentially-backed-off interval a single
        # half-open probe recompiles.  A transient compile fault (OOM on
        # the compile host, an injected chaos fault) therefore heals; a
        # deterministic pipeline bug re-opens on every probe without
        # burning a core in a retry loop.
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.compile_timeout_s = compile_timeout_s
        # requests currently executing (see request_began/request_ended):
        # the background worker defers compiles while this is nonzero
        self._serving = 0

    # -- dispatch --------------------------------------------------------------
    def key_of(self, env: Mapping[str, int]) -> BucketKey:
        return self.space.key_of(env)

    def lookup(self, env: Mapping[str, int]) -> Tuple[BucketPlan, bool]:
        """Dispatch an env: ``(plan, hit)``.

        A miss compiles the bucket synchronously — or, in background mode,
        schedules the compile on the worker and returns the whole-range
        fallback plan immediately (``hit`` is still ``False``)."""
        key = self.space.key_of(env)
        with self._lock:
            bp = self._plans.get(key)
            if bp is not None:
                self.hits += 1
                self.hits_by_key[key] = self.hits_by_key.get(key, 0) + 1
                self._plans.move_to_end(key)
                return bp, True
            self.misses += 1
            self.misses_by_key[key] = self.misses_by_key.get(key, 0) + 1
            if self.background:
                self._submit_background(key)
                self.fallback_serves += 1
                return self.fallback, False
        return self._specialize(key), False

    def get(self, key: BucketKey) -> BucketPlan:
        """Plan for a bucket key, compiling if needed (no hit/miss stats).

        Synchronous even on a background table: an in-flight background
        compile is awaited rather than duplicated.  A quarantined bucket
        (breaker open after a compile failure) raises
        :class:`BucketQuarantined` instead of compiling."""
        with self._lock:
            bp = self._plans.get(key)
            if bp is not None:
                self._plans.move_to_end(key)
                return bp
            fut = self._inflight.get(key)
        if fut is not None:
            fut.result()                  # join; failures live on the breaker
            with self._lock:
                bp = self._plans.get(key)
            if bp is not None:
                return bp
        return self._specialize(key)

    def peek(self, key: BucketKey) -> Optional[BucketPlan]:
        """Cached plan or ``None`` — never compiles, never reorders LRU."""
        with self._lock:
            return self._plans.get(key)

    def _specialize(self, key: BucketKey) -> BucketPlan:
        if not self.breaker.allow(key):
            raise BucketQuarantined(key, self.breaker.cause(key),
                                    self.breaker.retry_in_s(key))
        with self._compile_lock:
            with self._lock:              # a racer may have installed it
                bp = self._plans.get(key)
            if bp is not None:
                # the probe ticket (if any) resolves in the racer's favor
                self.breaker.record_success(key)
                return bp
            bp = self._timed_compile(key)
            # install before releasing the compile lock: a background
            # worker acquiring it next must see the bucket as resident
            self._install(key, bp)
        self.breaker.record_success(key)
        return bp

    def _timed_compile(self, key: BucketKey) -> BucketPlan:
        """One pipeline run under the breaker's watch.

        Exceptions and over-budget compiles record a failure on the
        breaker (tripping quarantine) and re-raise; a timed-out plan is
        discarded even though it finished — a compile that blows its
        budget signals a bucket whose pipeline cost is pathological, and
        serving its plan would hide that.  The caller records success
        only after the plan is installed."""
        t0 = time.monotonic()
        try:
            bp = self._compile_fn(key, self.space.ranges_of(key))
        except Exception as e:
            self.breaker.record_failure(key, e)
            raise
        elapsed = time.monotonic() - t0
        if self.compile_timeout_s is not None \
                and elapsed > self.compile_timeout_s:
            exc = CompileTimeout(
                f"bucket {key} specialization took {elapsed:.3f}s, over "
                f"the {self.compile_timeout_s}s budget; plan discarded")
            self.breaker.record_failure(key, exc)
            raise exc
        return bp

    def _install(self, key: BucketKey, bp: BucketPlan) -> None:
        """Atomically swap a compiled plan into the table (LRU applies)."""
        with self._lock:
            self.specialize_count += 1
            self._bounds[key] = bp.arena_bound_bytes
            self._plans[key] = bp
            self._plans.move_to_end(key)
            while len(self._plans) > self.max_live:
                self._plans.popitem(last=False)
                self.evictions += 1

    # -- background specialization ---------------------------------------------
    def _submit_background(self, key: BucketKey) -> None:
        """Schedule one compile for ``key`` unless resident, in flight, or
        quarantined.  The breaker gate is what turns every miss into a
        free re-probe opportunity: while open it answers ``False`` (the
        fallback keeps serving), and once the backoff elapses the next
        miss through here becomes the half-open probe compile.  Caller
        holds ``self._lock``."""
        if key in self._plans or key in self._inflight:
            return
        if not self.breaker.allow(key):
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="specialize")
        fut = self._pool.submit(self._compile_and_install, key)
        self._inflight[key] = fut

    def request_began(self) -> None:
        """Dispatch path: a request is about to execute its plan."""
        with self._lock:
            self._serving += 1

    def request_ended(self) -> None:
        with self._lock:
            self._serving -= 1

    def _compile_and_install(self, key: BucketKey) -> Optional[BucketKey]:
        try:
            # defer (bounded) until no request is mid-execution, so the
            # Python-heavy pipeline never steals the GIL from a serve
            deadline = time.monotonic() + _BACKGROUND_MAX_DEFER_S
            while time.monotonic() < deadline:
                with self._lock:
                    busy = self._serving > 0
                if not busy:
                    break
                time.sleep(_BACKGROUND_POLL_S)
            with self._compile_lock:
                with self._lock:
                    resident = key in self._plans
                if not resident:
                    bp = self._timed_compile(key)
                    self._install(key, bp)
            self.breaker.record_success(key)
            return key
        except Exception:
            # already recorded on the breaker by _timed_compile: the
            # bucket is quarantined and the fallback keeps serving it.
            # Swallow so the worker thread survives and joiners
            # (drain_background, get) see a clean future.
            return None
        finally:
            with self._lock:
                self._inflight.pop(key, None)

    def recompile(self, key: BucketKey, *, background: bool = False
                  ) -> Optional[BucketPlan]:
        """Force one bucket through the pipeline again and swap the result.

        The re-selection half of the kernel measured fallback: the caller
        updates what ``compile_fn`` will decide (e.g. a forced kernel
        variant per node), then this rebuilds the bucket's plan and
        atomically installs it — concurrent dispatch keeps hitting the old
        plan until the instant of the swap.  ``background=True`` runs the
        rebuild on the worker (requires a background table) and returns
        ``None``; synchronous calls return the fresh plan."""
        if background:
            if not self.background:
                raise ValueError(
                    "recompile(background=True) requires a background table")
            with self._lock:
                if key in self._inflight:
                    return None
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="specialize")
                # bypass _submit_background's residency check: the point
                # is to replace the resident plan
                fut = self._pool.submit(self._recompile_and_install, key)
                self._inflight[key] = fut
            return None
        with self._compile_lock:
            bp = self._timed_compile(key)
            self._install(key, bp)
        self.breaker.record_success(key)
        return bp

    def _recompile_and_install(self, key: BucketKey) -> Optional[BucketKey]:
        try:
            with self._compile_lock:
                bp = self._timed_compile(key)
                self._install(key, bp)
            self.breaker.record_success(key)
            return key
        except Exception:
            # recorded on the breaker by _timed_compile; keep the worker
            # alive and the future clean (see _compile_and_install)
            return None
        finally:
            with self._lock:
                self._inflight.pop(key, None)

    @property
    def n_pending(self) -> int:
        """Background specializations currently in flight."""
        with self._lock:
            return len(self._inflight)

    def drain_background(self, timeout: Optional[float] = None) -> List[BucketKey]:
        """Block until every background compile in flight *at call time*
        lands (compiles submitted by traffic arriving mid-drain belong to
        the next drain, so the call is bounded under sustained misses).

        Returns the drained bucket keys (first-submitted order).
        Compile failures do not raise here: a failed compile quarantines
        its bucket on the breaker (see :meth:`quarantined`) while the
        fallback keeps serving — the drain is a join, not a health check.
        ``timeout`` is one global deadline for the whole drain.  After a
        clean drain the table state is indistinguishable from having
        compiled those buckets synchronously."""
        with self._lock:
            snapshot = dict(self._inflight)
        deadline = None if timeout is None else time.monotonic() + timeout
        drained: List[BucketKey] = []
        for key, fut in snapshot.items():
            remaining = None if deadline is None                 else max(0.0, deadline - time.monotonic())
            done, not_done = futures_wait([fut], timeout=remaining)
            if not_done:
                raise TimeoutError(
                    f"background specialization of bucket {key} still "
                    f"pending after {timeout}s (drained so far: {drained})")
            drained.append(key)
            fut.result()                  # join; failures live on the breaker
        return drained

    def quarantined(self) -> List[BucketKey]:
        """Buckets currently quarantined (breaker open or half-open)."""
        return self.breaker.quarantined_keys()

    # -- warmup & introspection ------------------------------------------------
    def warmup(self, envs: Iterable[Mapping[str, int]]) -> List[BucketKey]:
        """Compile the buckets containing ``envs`` before traffic arrives.

        Synchronous and idempotent (already-compiled buckets are skipped,
        in-flight background compiles are awaited, not duplicated); returns
        the distinct bucket keys now resident, in first-seen order.
        """
        keys: List[BucketKey] = []
        for env in envs:
            key = self.space.key_of(env)
            if key not in keys:
                keys.append(key)
                self.get(key)
        return keys

    def arena_bound_bytes(self, key: BucketKey) -> Optional[int]:
        """Guaranteed worst-case arena size over the bucket's sub-ranges.

        Bounds are remembered across LRU eviction, so only a bucket never
        compiled before pays a pipeline run here; a known bucket answers
        from the bound cache without touching (or evicting from) the plan
        cache.  A background table never stalls the caller: an unknown
        bucket bound schedules the compile and conservatively answers with
        the whole-range bound, which every bucket is guaranteed to fit."""
        with self._lock:
            if key in self._bounds:
                return self._bounds[key]
            if self.background:
                self._submit_background(key)
                return self.fallback.arena_bound_bytes
        return self.get(key).arena_bound_bytes

    @property
    def compiled_keys(self) -> List[BucketKey]:
        with self._lock:
            return list(self._plans)

    @property
    def n_buckets(self) -> int:
        return self.space.n_buckets

    def per_bucket_stats(self) -> Dict[BucketKey, Dict[str, Any]]:
        """Per-bucket dispatch distribution + known arena bounds — every
        bucket traffic has ever touched, resident or evicted."""
        with self._lock:
            keys = set(self.hits_by_key) | set(self.misses_by_key) \
                | set(self._bounds)
            return {k: {"hits": self.hits_by_key.get(k, 0),
                        "misses": self.misses_by_key.get(k, 0),
                        "arena_bound_bytes": self._bounds.get(k),
                        "resident": k in self._plans}
                    for k in sorted(keys)}

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "specialize_count": self.specialize_count,
                    "evictions": self.evictions,
                    "resident": len(self._plans),
                    "fallback_serves": self.fallback_serves,
                    "background_pending": len(self._inflight),
                    "background_failed":
                        len(self.breaker.quarantined_keys())}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SpecializationTable({self.space!r}, "
                f"resident={len(self._plans)}/{self.max_live}, "
                f"hits={self.hits}, specializations={self.specialize_count})")
