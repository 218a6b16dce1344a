"""Public API of the BladeDISC++-style memory optimizer (PyTorch port).

    B, S = symbolic_dims("b, s")
    opt = optimize(step, params_spec, {"tokens": TensorSpec((B, S), torch.int32)},
                   dynamic_dims={"b": (1, 8), "s": (16, 1024)},
                   memory_limit=cap)          # or opt.with_memory_limit(cap)
    out = opt(params, batch)                  # any (b, s) in range, no retrace
    opt.last_report.stats.device_peak         # exact planned peak bytes

``optimize`` performs the paper's pipeline once at "compile" time:
symbolic capture → symbolic shape graph → op scheduling (§2.2) →
rematerialization search (§2.3 compile-time half) → memory planning →
kernel-variant selection → lowering to a flat ``Program``.  Calls then
execute through the register ``ProgramVM`` on the plan's device: the fast
stream when the call's replayed peak fits the memory limit, else the
dynamic stream, whose evict checks run the runtime remat policy (§2.3
runtime half).  ``executor="reference"`` runs the op-by-op
``PlanInterpreter`` instead.

With ``buckets=...`` the declared shape space is additionally partitioned
into buckets and the schedule → remat → memplan → kernel-selection
pipeline re-runs lazily once per bucket under the bucket's tighter bounds
(incrementally: the whole-range schedule and remat plan are reused where
no verdict they depended on flips); each call dispatches to its bucket's
plan in O(log n) per dim through a :class:`SpecializationTable` with LRU
retention.

Every ``optimize`` records its compile phases as spans (``fn.trace``) and
the decisions only observable while they happen (``fn.decisions``);
``enable_telemetry`` attaches a per-call ring, ``memory_timeline(env)``
replays a lowered Program into a plan-vs-actual memory curve, and
``explain`` renders all of it (:mod:`repro_torch.core.obs`).

``resilience=`` attaches the degradation ladder
(:mod:`repro_torch.core.resilience`): a call that fails at run time
retries in place (transient faults) or on the whole-range plan (memory
pressure — on the card a real ``torch.cuda.OutOfMemoryError`` too — and
quarantined bucket compiles), and raises a structured ``RequestFailed``
when retries run out; ``fault_plan=`` / ``inject_faults`` install a
seeded fault schedule.
"""
from __future__ import annotations

import threading
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple, Union)

import torch
from torch.utils import _pytree as pytree

from .dispatch import (BucketKey, BucketPlan, BucketSpace, BucketsSpec,
                       SpecializationTable, build_bucket_space)
from .executor.interpreter import PlanInterpreter
from .executor.memory import MemoryLimitExceeded
from .executor.vm import ProgramVM, RunReport
from .ir.dynamism import complete_bound_env
from .ir.capture import (TensorSpec, capture, check_declared_ranges,
                         solve_env, spec_like, symbolic_dims, tree_flatten,
                         tree_unflatten)
from .lowering import Program, lower_plan
from .memplan import ArenaPlan, build_arena_plan
from .memplan.arena import ArenaExhausted
from .obs import NULL_TRACER, DecisionLog, Telemetry, Tracer
from .remat.planner import ExecutionPlan, build_plan
from .resilience import (BucketQuarantined, CircuitBreaker, CompileFault,
                         FaultPlan, FaultPlanRef, OffloadFailure,
                         RegenFailure, RequestFailed, ResilienceConfig,
                         ResilienceController, TransientKernelError)
from .scheduling.exchange import exchange_pass
from .scheduling.memsim import simulate_peak, simulate_peak_bound
from .scheduling.scheduler import ScheduleResult, schedule_graph
from .symbolic import ShapeGraph, declare_dim_ranges

__all__ = ["optimize", "DynamicShapeFunction", "OptimizeReport",
           "MemoryLimitExceeded", "TensorSpec", "scan", "symbolic_dims",
           "spec_like",
           "resolve_device", "BucketSpace", "SpecializationTable",
           "BucketPlan", "build_bucket_space"]

_EXECUTORS = ("vm", "reference")


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another; asking for ``cuda`` without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def scan(body: Callable, init: Any, xs: Any) -> Tuple[Any, Any]:
    """``carry, ys = scan(body, init, xs)`` with rolled-loop compilation
    under :func:`optimize`; ``body(carry, x) -> (carry, y)`` over the
    leading dim of ``xs``.

    Inside a function passed to :func:`optimize`, the scan is captured
    once (torch's ``torch.ops.higher_order.scan`` is the capture marker).
    One whose ``xs`` have a *symbolic* length is compiled to a single
    ``Loop`` instruction: the lowered ``Program`` stays O(body size) and
    the planned arena bound is independent of the trip count (carried
    values ping-pong between two slot generations across the back-edge;
    per-iteration temporaries die and their slots are reused every
    iteration).  A scan the roll gate refuses (a static length, a body
    with a bounded dim, a carry passed through to another slot, a scan
    nested in a rolled body) becomes one opaque node, as the reference
    keeps it: the plan counts its outputs, and its body runs as one op,
    its own temporaries outside ``device_peak``.  Outside ``optimize``
    this runs the body in a Python loop and stacks the ``ys``.
    """
    from torch._subclasses.fake_tensor import FakeTensor

    leaves = pytree.tree_leaves((init, xs))
    if torch.compiler.is_dynamo_compiling() or \
            any(isinstance(t, FakeTensor) for t in leaves):
        return _traced_scan(body, init, xs)
    x_leaves, x_tree = pytree.tree_flatten(xs)
    n = x_leaves[0].shape[0] if x_leaves else 0
    if n == 0:
        raise ValueError("scan needs xs with a nonzero leading dim")
    carry, ys = init, []
    for i in range(n):
        carry, y = body(carry, pytree.tree_unflatten(
            [x[i] for x in x_leaves], x_tree))
        ys.append(y)
    y_leaves = [pytree.tree_flatten(y)[0] for y in ys]
    y_tree = pytree.tree_flatten(ys[0])[1]
    return carry, pytree.tree_unflatten(
        [torch.stack(col) for col in zip(*y_leaves)], y_tree)


def _traced_scan(body: Callable, init: Any, xs: Any) -> Tuple[Any, Any]:
    """torch's scan under capture (or inside the body of one, which dynamo
    traces).  Its body may not return one of its inputs, or one tensor
    twice, so such an output (a carry passed through) is copied.  torch
    compiles the outermost scan with dynamo, whose cache is kept on the
    code of torch's own wrapper: an earlier capture's entry would match a
    symbolic size at its static trace-time value and pin it, so the entry
    is dropped first."""
    from torch._higher_order_ops.scan import scan as torch_scan

    def unaliased(carry, x):
        seen = pytree.tree_leaves((carry, x))
        out_leaves, out_tree = pytree.tree_flatten(body(carry, x))
        owned = []
        for o in out_leaves:
            if any(o is t for t in seen):
                o = o.clone()
            seen.append(o)
            owned.append(o)
        return pytree.tree_unflatten(owned, out_tree)

    if torch.compiler.is_dynamo_compiling():
        return torch_scan(unaliased, init, xs)
    for code in torch_scan.__code__.co_consts:
        if getattr(code, "co_name", "") == "run_flattened_scan":
            torch._C._dynamo.eval_frame.reset_code(code)
    try:
        return torch_scan(unaliased, init, xs)
    except Exception as e:
        if "PendingUnbackedSymbolNotFound" not in f"{type(e).__name__} {e}":
            raise
        # torch 2.11's scan cannot trace a body that makes a size from
        # values (a bounded op) without returning it; 2.13's can
        raise NotImplementedError(
            f"a bounded dim inside a scan body: torch {torch.__version__}'s "
            f"scan cannot capture it ({type(e).__name__})") from e


@dataclass
class OptimizeReport:
    schedule: ScheduleResult
    used_scheduled_order: bool
    # rematerialization search: candidates, those with a beneficial
    # recompute subgraph, and those whose regen method bounds fixed
    n_candidates: int = 0
    n_recomputable: int = 0
    n_static_regen: int = 0
    # guaranteed worst-case peak bytes over the declared dim ranges
    # (None when some dim has no declared upper bound)
    peak_bound_bytes: Optional[int] = None
    peak_bound_lo: Optional[int] = None
    # memory planner (memory_plan="arena"): guaranteed worst-case arena
    # size over the declared dim ranges, slot count, planned reuse split
    arena_bound_bytes: Optional[int] = None
    n_arena_slots: int = 0
    n_provable_reuses: int = 0
    n_checked_reuses: int = 0
    # snapshot of ShapeGraph.cmp_stats after this compile
    cmp_stats: Dict[str, int] = field(default_factory=dict)
    # the ShapeEnv guards the capture left (strings; for inspection)
    guards: List[str] = field(default_factory=list)
    # the bucket partition (whole-range report only; None without buckets=)
    buckets: Optional[BucketSpace] = None
    # incremental bucket compile: True when this report's schedule + remat
    # plan were inherited from the whole-range compile because no verdict
    # they depended on flipped under the bucket's narrowed ranges
    reused_parent_schedule: bool = False
    # weaker reuse: the bucket's scheduler re-ran (some remat verdict
    # flipped) but reproduced the parent's raw order, so the parent's
    # guard/exchange post-pass result was adopted without re-simulation
    reused_parent_postpass: bool = False
    # host seconds this plan's pipeline took (capture excluded)
    compile_s: float = 0.0


@dataclass
class PipelineArtifacts:
    """What one ``_compile_pipeline`` run hands to incremental re-runs.

    ``cmp_keys`` is the set of ``ShapeGraph.compare`` keys the scheduling
    and remat phases consulted (recorded via
    :meth:`ShapeGraph.record_cmp_keys`); ``sg`` is the graph whose memo
    holds those verdicts.  A bucket compile under ``sg.specialized(...)``
    reuses ``sched``/``candidates`` wholesale when
    :meth:`ShapeGraph.verdicts_match` proves none of those verdicts flip
    under the narrowed ranges — only the bounds-dependent phases (memory
    planning, kernel selection, peak bounds, lowering) re-run.
    """

    sched: ScheduleResult
    used_sched: bool
    candidates: Dict[int, Any]            # value id -> CandidateInfo
    cmp_keys: frozenset
    sg: ShapeGraph
    # the scheduler's raw order (node ids, before the best-of guard and
    # exchange refinement): a bucket whose re-run scheduler reproduces it
    # adopts the parent's guarded + exchanged final order without re-paying
    # the probe simulations
    raw_order_ids: Tuple[int, ...] = ()
    # shared range-independent expression caches: scheduler impact
    # polynomials and remat-search (impact, sources)/flops — re-running a
    # phase under a narrowed graph re-decides verdicts, not expressions
    sched_expr_cache: Dict = field(default_factory=dict)
    remat_expr_cache: Dict = field(default_factory=dict)
    # per-candidate compare keys of the remat search, for candidate-granular
    # reuse when only some verdicts flip under a bucket
    cand_cmp_keys: Dict[int, frozenset] = field(default_factory=dict)


def _compile_pipeline(graph, sg: ShapeGraph, *,
                      enable_scheduling: bool = True,
                      enable_remat: bool = True,
                      max_subgraph: int = 24,
                      memory_plan: str = "arena",
                      donate_inputs: bool = False,
                      count_inputs: bool = True,
                      guard_env: Optional[Dict[str, int]] = None,
                      parent: Optional[PipelineArtifacts] = None,
                      collect: bool = False,
                      tracer: Any = NULL_TRACER,
                      decisions: Optional[DecisionLog] = None,
                      kernel_select: bool = True,
                      kernel_forced: Optional[Mapping[int, str]] = None,
                      hw: Any = None,
                      ) -> Tuple[ExecutionPlan, OptimizeReport,
                                 Optional[PipelineArtifacts]]:
    """schedule → remat search → memplan → kernel selection → bounds over
    a captured graph.

    Factored out of :func:`optimize` so bucketed specialization can re-run
    it per bucket: the same graph compiles under a narrowed ``ShapeGraph``
    (see :meth:`ShapeGraph.specialized`) and the tighter bounds resolve
    more decisions statically.

    ``collect=True`` records the compare keys the schedule + remat phases
    depend on and returns them as :class:`PipelineArtifacts` (third tuple
    element, else ``None``).  ``parent=`` makes this run *incremental*:
    when no recorded verdict flips under ``sg``'s narrowed ranges, the
    parent's schedule and remat candidates are reused (intervals refreshed
    under the tighter bounds) and only memory planning, kernel selection
    and peak bounds run.  ``hw`` is the kernel cost model's
    :class:`~repro_torch.kernels.hw_model.HardwareModel`.  Each phase runs
    under a ``tracer`` span; the decisions only observable while they
    happen land in ``decisions`` (a fresh log when ``None``).
    """
    from .remat.search import respecialize_candidates

    t_start = time.perf_counter()
    dl = decisions if decisions is not None else DecisionLog()

    def _cmp_delta(before: Dict[str, int]) -> Dict[str, int]:
        """How many comparisons this phase resolved per layer."""
        return {k: sg.cmp_stats.get(k, 0) - before.get(k, 0)
                for k in set(sg.cmp_stats) | set(before)
                if sg.cmp_stats.get(k, 0) != before.get(k, 0)}

    def _clamp(name: str, v: int) -> int:
        iv = sg.declared_ranges.get(name)
        if iv is None:
            return v
        if iv.lo is not None:
            v = max(v, iv.lo)
        if iv.hi is not None:
            v = min(v, iv.hi)
        return v

    candidates: Optional[Dict[int, Any]] = None
    used_sched = False
    reused = False
    reused_postpass = False
    raw_order_ids: Tuple[int, ...] = ()
    recorded: set = set()
    cand_keys: Dict[int, frozenset] = {}
    sched_cache = parent.sched_expr_cache if parent is not None else {}
    remat_cache = parent.remat_expr_cache if parent is not None else {}
    cmp0 = dict(sg.cmp_stats)
    with tracer.span("schedule", n_nodes=len(graph.nodes)) as _ssp:
        if parent is not None and enable_scheduling and \
                sg.verdicts_match(parent.sg, parent.cmp_keys):
            # incremental fast path: every schedule/remat decision would
            # come out identical — reuse them; bounds-dependent phases
            # still re-run
            sched = parent.sched
            used_sched = parent.used_sched
            candidates = respecialize_candidates(parent.candidates, sg) \
                if enable_remat else {}
            reused = True
            dl.add("bucket-reuse", "schedule+remat", "inherit",
                   "no compare verdict the parent depended on flips under "
                   "the narrowed ranges",
                   n_candidates=len(candidates or {}))
        elif enable_scheduling:
            with sg.record_cmp_keys() as keys:
                sched = schedule_graph(graph, sg,
                                       impact_expr_cache=sched_cache)
            recorded |= keys
            raw_order_ids = tuple(n.id for n in sched.order)
            if parent is not None and parent.raw_order_ids == raw_order_ids:
                # the narrowed ranges changed some remat verdict but not the
                # schedule itself: adopt the parent's guarded + exchanged
                # final order (already proven no worse at the parent's probe
                # envs)
                sched = ScheduleResult(list(parent.sched.order),
                                       sched.symbolic_decisions,
                                       sched.tiebreak_decisions)
                used_sched = parent.used_sched
                reused_postpass = True
                dl.add("bucket-reuse", "schedule post-pass", "inherit",
                       "re-run scheduler reproduced the parent's raw order; "
                       "adopting its guarded + exchanged result")
            else:
                # guard envs bind the *declared* dims only; value-dependent
                # bounded dims complete to their caps per probe env (a
                # bounded dim's guard value must track its cap, not a fixed
                # 64)
                free_syms = graph.free_symbols() - set(graph.bound_dims)
                env = dict(guard_env) if guard_env else \
                    {n: 64 for n in free_syms}
                for name in free_syms:
                    env.setdefault(name, 64)
                env = {k: _clamp(k, v) for k, v in env.items()}
                probe_envs = [complete_bound_env(graph, e) for e in (
                    env,
                    {k: _clamp(k, max(1, v // 4)) for k, v in env.items()},
                    {k: _clamp(k, v * 4) for k, v in env.items()})]
                env = probe_envs[0]
                # best-of safeguard: never keep an order that regresses the
                # program order's peak at the guard env
                base = simulate_peak(graph, graph.nodes, env,
                                     count_inputs=count_inputs)
                tuned = simulate_peak(graph, sched.order, env,
                                      count_inputs=count_inputs)
                used_sched = tuned.peak_bytes <= base.peak_bytes
                kept_peak = min(tuned.peak_bytes, base.peak_bytes)
                dl.add("schedule-guard", "scheduled order",
                       "keep" if used_sched else "revert",
                       f"scheduled peak {tuned.peak_bytes:,} vs program "
                       f"order {base.peak_bytes:,} at the guard env",
                       guard_env=dict(env),
                       scheduled_peak=tuned.peak_bytes,
                       base_peak=base.peak_bytes)
                if not used_sched:
                    sched = ScheduleResult(list(graph.nodes),
                                           sched.symbolic_decisions,
                                           sched.tiebreak_decisions)
                # pairwise-exchange refinement, guarded at the probe envs
                with tracer.span("exchange") as _xsp:
                    n_sw0 = len(dl.entries("exchange-swap"))
                    refined = exchange_pass(graph, sched.order, probe_envs,
                                            decisions=dl)
                    _xsp.attrs["n_swaps"] = \
                        len(dl.entries("exchange-swap")) - n_sw0
                refined_peak = simulate_peak(
                    graph, refined, env, count_inputs=count_inputs).peak_bytes
                if refined_peak <= kept_peak:
                    sched = ScheduleResult(refined, sched.symbolic_decisions,
                                           sched.tiebreak_decisions)
                    _xsp.attrs["adopted"] = True
                else:
                    dl.add("schedule-guard", "exchange refinement", "discard",
                           f"refined peak {refined_peak:,} exceeds kept "
                           f"peak {kept_peak:,} at the guard env")
                    _xsp.attrs["adopted"] = False
        else:
            sched = ScheduleResult(list(graph.nodes), 0, 0)
        _ssp.attrs.update(reused_parent=reused,
                          reused_postpass=reused_postpass,
                          used_scheduled_order=used_sched,
                          cmp=_cmp_delta(cmp0))

    arena_plan = None
    if memory_plan == "arena":
        with tracer.span("memplan") as _msp:
            arena_plan = build_arena_plan(graph, sched.order, sg,
                                          donate_inputs=donate_inputs)
            _msp.attrs.update(
                n_slots=arena_plan.n_slots,
                arena_bound_bytes=arena_plan.arena_bound_bytes,
                n_provable_reuses=arena_plan.n_provable_reuses,
                n_checked_reuses=arena_plan.n_checked_reuses)
            dl.add("slot-pack", "arena",
                   f"{arena_plan.n_slots} slots",
                   "liveness intervals packed by symbolic-size compatibility "
                   "(reuse proven through the shape graph)",
                   n_provable_reuses=arena_plan.n_provable_reuses,
                   n_checked_reuses=arena_plan.n_checked_reuses,
                   arena_bound_bytes=arena_plan.arena_bound_bytes)
    if candidates is not None:
        plan = ExecutionPlan(graph=graph, order=list(sched.order),
                             shape_graph=sg, candidates=candidates,
                             arena_plan=arena_plan)
    else:
        cmp1 = dict(sg.cmp_stats)
        with tracer.span("remat") as _rsp:
            with sg.record_cmp_keys() as keys:
                plan = build_plan(graph, sched, sg, enable_remat=enable_remat,
                                  max_subgraph=max_subgraph,
                                  arena_plan=arena_plan,
                                  remat_expr_cache=remat_cache,
                                  cand_keys_out=cand_keys if collect else None,
                                  parent_remat=None if parent is None else
                                  (parent.sg, parent.candidates,
                                   parent.cand_cmp_keys))
            _rsp.attrs.update(n_candidates=plan.n_candidates,
                              n_recomputable=plan.n_recomputable,
                              n_static_regen=plan.n_static_regen,
                              cmp=_cmp_delta(cmp1))
        recorded |= keys
        for vid, method in sorted(plan.static_methods.items()):
            dl.add("remat-static", f"%{vid}", method,
                   "interval bounds over the declared ranges fix the cheaper "
                   "regeneration method at compile time")
    if kernel_select:
        # kernel-variant selection: score every variant of every kernel
        # node over THIS plan's interval bounds — a bucket's narrowed
        # ranges may admit a variant the whole range cannot (the plain
        # version's transients), the whole-range plan keeps whatever stays
        # valid at its widest corner.  Overrides live on the plan, never
        # on the shared graph nodes.
        from ..kernels.hw_model import DEFAULT_HW
        from ..kernels.variants import select_kernels
        with tracer.span("kernel-select") as _kspan:
            sels = select_kernels(graph, sg,
                                  hw if hw is not None else DEFAULT_HW,
                                  forced=kernel_forced, decisions=dl)
            plan.kernel_selections = sels
            plan.kernel_overrides = {
                nid: s.variant.overrides() for nid, s in sels.items()}
            _kspan.attrs.update(
                n_kernels=len(sels),
                n_non_default=sum(1 for s in sels.values()
                                  if not s.is_default))
    peak_lo = peak_hi = None
    if sg.declared_ranges:  # without ranges the bound is vacuous (hi = None)
        with tracer.span("bounds") as _bsp:
            peak_lo, peak_hi = simulate_peak_bound(
                graph, sched.order, sg, count_inputs=count_inputs,
                donate_inputs=donate_inputs)
            _bsp.attrs.update(peak_bound_lo=peak_lo, peak_bound_bytes=peak_hi)
    report = OptimizeReport(schedule=sched, used_scheduled_order=used_sched,
                            n_candidates=plan.n_candidates,
                            n_recomputable=plan.n_recomputable,
                            n_static_regen=plan.n_static_regen,
                            peak_bound_bytes=peak_hi, peak_bound_lo=peak_lo,
                            cmp_stats=dict(sg.cmp_stats),
                            reused_parent_schedule=reused,
                            reused_parent_postpass=reused_postpass)
    if arena_plan is not None:
        report.arena_bound_bytes = arena_plan.arena_bound_bytes
        report.n_arena_slots = arena_plan.n_slots
        report.n_provable_reuses = arena_plan.n_provable_reuses
        report.n_checked_reuses = arena_plan.n_checked_reuses
    artifacts = None
    if collect:
        artifacts = PipelineArtifacts(sched=sched, used_sched=used_sched,
                                      candidates=dict(plan.candidates),
                                      cmp_keys=frozenset(recorded), sg=sg,
                                      raw_order_ids=raw_order_ids,
                                      sched_expr_cache=sched_cache,
                                      remat_expr_cache=remat_cache,
                                      cand_cmp_keys=cand_keys)
    report.compile_s = time.perf_counter() - t_start
    return plan, report, artifacts


def _build_executor(plan: ExecutionPlan, report: OptimizeReport,
                    executor: str, *, memory_limit: Optional[int],
                    donate_inputs: bool, count_inputs: bool,
                    tracer: Any = NULL_TRACER,
                    arena_hard_cap: Optional[int] = None):
    """Lower + wrap ``plan`` for one executor kind.

    ``executor="vm"`` lowers the plan to a flat :class:`Program` (the
    guaranteed peak bound decides whether the evict path is emitted) and
    runs it on :class:`ProgramVM`; ``"reference"`` keeps the op-by-op
    :class:`PlanInterpreter` for differential testing.  Returns
    ``(runner, program)`` — ``program`` is ``None`` for the reference
    interpreter.  ``arena_hard_cap`` (``resilience.enforce_arena_bound``)
    holds the runner to that arena size.  Lowering touches no device (it
    only builds Python structures), so a background worker thread may run
    it."""
    if executor not in _EXECUTORS:
        raise ValueError(
            f"executor must be one of {_EXECUTORS}, got {executor!r}")
    if executor == "reference":
        return PlanInterpreter(plan, memory_limit=memory_limit,
                               donate_inputs=donate_inputs,
                               count_inputs=count_inputs,
                               arena_hard_cap=arena_hard_cap), None
    with tracer.span("lower") as sp:
        program = lower_plan(plan, memory_limit=memory_limit,
                             donate_inputs=donate_inputs,
                             count_inputs=count_inputs,
                             peak_bound_bytes=report.peak_bound_bytes)
        sp.attrs["n_instructions"] = program.n_instructions
        sp.attrs["has_evict_path"] = program.has_evict_path
    return ProgramVM(program, arena_hard_cap=arena_hard_cap), program


def _drop_frames(err: BaseException) -> None:
    """Release what a failed attempt's frames hold (its register file: on
    the card, device tensors) and drop the ladder's own, still running,
    frame from ``err``'s traceback, so the exception kept for the next
    rung forms no reference cycle through it.  A failed attempt then
    leaves ``memory_allocated()`` where it found it without waiting for
    a garbage collection."""
    tb = err.__traceback__
    if tb is not None:
        traceback.clear_frames(tb.tb_next)
        err.__traceback__ = tb.tb_next


class DynamicShapeFunction:
    """A compiled-once, run-any-shape callable with memory optimization.

    A returned tensor with a value-dependent bounded dim (``__b<k>``, from
    ``masked_select`` and the like) comes back at its measured extent; the
    reference's comes back padded to the cap.  The measured extents are in
    ``last_report.stats.measured_dims`` and ``last_report.env``."""

    def __init__(self, plan: ExecutionPlan, report: OptimizeReport, *,
                 device: torch.device, memory_limit: Optional[int] = None,
                 donate_inputs: bool = False, count_inputs: bool = True,
                 executor: str = "vm",
                 table: Optional[SpecializationTable] = None,
                 table_factory: Optional[
                     Callable[[Optional[int]], SpecializationTable]] = None,
                 kernel_forced: Optional[Dict[Optional[BucketKey],
                                              Dict[int, str]]] = None,
                 kernel_remeasure_after: Optional[int] = None,
                 hw: Any = None,
                 tracer: Optional[Tracer] = None,
                 decisions: Optional[DecisionLog] = None,
                 resilience_config: Optional[ResilienceConfig] = None,
                 fault_ref: Optional[FaultPlanRef] = None):
        self.plan = plan
        self.report = report
        self.device = device
        self.memory_limit = memory_limit
        self.executor = executor
        self._donate_inputs = donate_inputs
        self._count_inputs = count_inputs
        # observability: compile-span tree + decision log (shared with every
        # bucket compile), per-call telemetry off by default (see
        # enable_telemetry — the disabled hot path pays one attribute test)
        self.trace = tracer if tracer is not None else Tracer()
        self.decisions = decisions if decisions is not None else DecisionLog()
        self._telemetry: Optional[Telemetry] = None
        # resilience: degradation ladder + fault injection, off by default
        # (the disabled hot path is one attribute test, like telemetry).
        # The FaultPlanRef is shared with the bucket-compile closure so
        # inject_faults() can swap plans after the table factory captured it
        self._fault_ref = fault_ref if fault_ref is not None else FaultPlanRef()
        self._resilience_config = resilience_config
        self._resilience: Optional[ResilienceController] = None
        if resilience_config is not None:
            self._resilience = ResilienceController(
                resilience_config, fault_ref=self._fault_ref,
                decisions=self.decisions)
        arena_hard_cap = None
        if resilience_config is not None \
                and resilience_config.enforce_arena_bound:
            arena_hard_cap = report.arena_bound_bytes
        # a background table already lowered the identical whole-range plan
        # for its fallback: adopt it instead of lowering twice
        if table is not None and table.fallback is not None:
            self.interp = table.fallback.interp
            self._program = table.fallback.program
        else:
            self.interp, self._program = _build_executor(
                plan, report, executor, memory_limit=memory_limit,
                donate_inputs=donate_inputs, count_inputs=count_inputs,
                tracer=self.trace, arena_hard_cap=arena_hard_cap)
        self.last_report: Optional[RunReport] = None
        graph = plan.graph
        self._in_tree = graph.in_tree
        self._out_tree = graph.out_tree
        self._in_dtypes = [v.dtype for v in graph.inputs]
        # bucketed dispatch: the table, the factory that rebuilds it under
        # another memory limit, and the bucket / arena bound of the plan
        # the most recent call executed (the whole-range bound on a
        # fallback or unbucketed call)
        self._table = table
        self._table_factory = table_factory
        self.last_bucket: Optional[BucketKey] = None
        self.last_arena_bound: Optional[int] = None
        self._dispatch_ns_total = 0
        self._stats_lock = threading.Lock()
        # kernel measured fallback: per-bucket forced variants (shared with
        # the bucket compile closure — recompiles read it), the auto-trigger
        # threshold, per-bucket call counts, and in-flight measure threads
        self._hw = hw
        self._kernel_forced = kernel_forced if kernel_forced is not None \
            else {}
        self._kernel_remeasure_after = kernel_remeasure_after
        self._kernel_calls: Dict[Optional[BucketKey], int] = {}
        self._kernel_measured: set = set()
        self._remeasure_threads: List[threading.Thread] = []

    def __call__(self, *args):
        return self.call_donated(list(args))

    def call_donated(self, args: List[Any]):
        """Call with the positional arguments in the list ``args``, taking
        them out of it (the list is left empty).

        Under ``donate_inputs=True`` the executor drops its reference to a
        donated buffer at the buffer's death point, and the memory returns
        to the caching allocator there only if nothing else refers to the
        tensor.  A plain call cannot arrange that: the caller's arguments
        stay referenced until the call returns.  A caller that puts the
        arguments in a list, keeps no other reference to them, and passes
        the list here donates them for real.  A ``None`` in an argument or
        output pytree is an empty subtree, as in the reference's pytrees."""
        flat, in_tree = tree_flatten(tuple(args))
        args.clear()
        if in_tree != self._in_tree:
            raise TypeError(f"pytree structure mismatch: traced "
                            f"{self._in_tree}, got {in_tree}")
        self._check_args(flat)
        res = self._resilience
        if res is not None:
            outs = self._call_resilient(res, flat)
        else:
            outs = self._dispatch(flat)
        return tree_unflatten(outs, self._out_tree)

    def _dispatch(self, flat: List[Any], *, force_fallback: bool = False,
                  faults: Any = None) -> List[Any]:
        """Select a plan and execute once (one ladder attempt).

        ``force_fallback=True`` serves the whole-range plan regardless of
        bucketing — the degradation ladder's remat-heavier retry rung,
        bitwise-identical to the bucket plans.  ``faults`` is an armed
        :class:`~repro_torch.core.resilience.faults.CallFaults` probe
        threaded down to the executor (``None`` keeps every hot loop
        uninstrumented)."""
        env = solve_env(self.plan.graph, flat)
        # the declared-range contract is checked against the whole-range
        # graph before bucket dispatch, so an out-of-range dim cannot land
        # in an edge bucket and fail there with a sub-range message
        check_declared_ranges(self.plan.shape_graph, env)
        if self._table is None or force_fallback:
            self.last_bucket = None if self._table is None \
                else self._table.key_of(env)
            self.last_arena_bound = self.report.arena_bound_bytes
            outs, report = self.interp.run(flat, env=env, faults=faults)
            self.last_report = report
            tel = self._telemetry
            if tel is not None:
                self._record_call(tel, report, self._program)
            return outs
        # the began/ended bracket tells the background worker a request is
        # mid-flight so compiles defer instead of contending for the GIL
        # (skipped without a worker: two lock round-trips per call).  It
        # opens before the lookup, which may submit this bucket's compile:
        # a worker thread started by that submit runs at once, and would
        # find no request in flight if the bracket opened after it
        background = self._table.background
        if background:
            self._table.request_began()
        try:
            t0 = time.perf_counter_ns()
            bp, _hit = self._table.lookup(env)
            dispatch_ns = time.perf_counter_ns() - t0
            # bp.key is None when a background miss served the whole-range
            # fallback; re-derive the bucket from this request's own env.
            # Set before the run so a fault aborting it still leaves the
            # failing bucket on record for the degradation events
            self.last_bucket = bp.key if bp.key is not None \
                else self._table.key_of(env)
            self.last_arena_bound = bp.report.arena_bound_bytes
            outs, report = bp.interp.run(flat, env=env, faults=faults)
        finally:
            if background:
                self._table.request_ended()
        st = report.stats
        st.last_dispatch_ns = dispatch_ns
        with self._stats_lock:
            self._dispatch_ns_total += dispatch_ns
            st.dispatch_ns_total = self._dispatch_ns_total
        st.bucket_hits = self._table.hits
        st.specialize_count = self._table.specialize_count
        self.last_report = report
        if self._kernel_remeasure_after is not None:
            self._maybe_remeasure(self.last_bucket, env)
        tel = self._telemetry
        if tel is not None:
            self._record_call(tel, report, bp.program)
        return outs

    def _call_resilient(self, res: ResilienceController,
                        flat: List[Any]) -> List[Any]:
        """Degradation-ladder dispatch (resilience enabled).

        Rungs, in order: the plain dispatch (whose executor already runs
        eviction under memory pressure before anything escapes), a
        bounded same-plan retry for transient faults, a retry on the
        remat-heavier whole-range fallback plan for memory pressure
        (``MemoryLimitExceeded``, ``ArenaExhausted``, a real
        ``torch.cuda.OutOfMemoryError``) and quarantined/failed bucket
        compiles (bitwise-identical results), and finally a structured
        :class:`RequestFailed`.  Every step is recorded as a
        :class:`~repro_torch.core.resilience.DegradationEvent` on the
        controller, the decision log, and Prometheus counters.  Malformed
        requests reject immediately — client errors never retry.  Any
        other error (a kernel's launch error, an illegal address, a
        failed build) propagates unchanged.

        Each attempt runs on its own copy of the argument list under
        ``donate_inputs``: a retry needs the inputs, so under the ladder
        a donated input stays referenced until the call returns."""
        seq = res.begin_call()
        fp = res.fault_plan
        armed = fp.arm_call(seq) if fp is not None else None
        if armed is not None and armed.take_malformed():
            res.note_degraded_call()
            ev = res.record("reject-malformed", seq=seq, attempt=0,
                            cause="malformed-env")
            raise RequestFailed(
                f"call {seq}: malformed request rejected before dispatch",
                attempts=0, events=(ev,))
        pol = res.config.retry
        events: List[Any] = []
        attempt = 0
        force_fb = False
        degraded = False
        while True:
            args = list(flat) if self._donate_inputs else flat
            try:
                return self._dispatch(args, force_fallback=force_fb,
                                      faults=armed)
            except (TransientKernelError, RegenFailure,
                    OffloadFailure) as e:
                err, rung, fb_next = e, "retry-transient", force_fb
            except (MemoryLimitExceeded, ArenaExhausted,
                    torch.cuda.OutOfMemoryError) as e:
                err, rung, fb_next = e, "retry-fallback", True
            except (CompileFault, BucketQuarantined) as e:
                err, rung, fb_next = e, "retry-fallback", True
            del args
            _drop_frames(err)
            if not degraded:
                degraded = True
                res.note_degraded_call()
            if attempt >= pol.max_retries:
                events.append(res.record("reject", seq=seq, attempt=attempt,
                                         cause=err, bucket=self.last_bucket))
                try:
                    env = solve_env(self.plan.graph, flat)
                except Exception:
                    env = None
                raise RequestFailed(
                    f"call {seq} failed after {attempt + 1} attempt(s): "
                    f"{err!r}", env=env, bucket=self.last_bucket,
                    attempts=attempt + 1, cause=err,
                    events=tuple(events)) from err
            backoff = pol.backoff_s(attempt)
            events.append(res.record(rung, seq=seq, attempt=attempt,
                                     cause=err, backoff_s=backoff,
                                     bucket=self.last_bucket))
            if backoff > 0:
                res.sleep(backoff)
            force_fb = fb_next
            attempt += 1
            # re-arm per attempt: specs spent on this attempt no longer
            # match, which is what lets a bounded retry actually recover
            armed = fp.arm_call(seq) if fp is not None else None

    def _record_call(self, tel: Telemetry, report: RunReport,
                     program: Optional[Program]) -> None:
        """Telemetry-enabled path only (never reached when disabled)."""
        trips: Tuple[int, ...] = ()
        if program is not None and program.loops:
            trips = tuple(rl.trip
                          for rl in program.resolve(report.env).loops)
        key = self.last_bucket if self._table is not None else None
        tel.on_call(key, report, program=program, loop_trips=trips)

    def _check_args(self, flat: List[Any]) -> None:
        for x, dt in zip(flat, self._in_dtypes):
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"expected a tensor, got {type(x).__name__}")
            if x.device != self.device and not (
                    x.device.type == self.device.type
                    and self.device.index is None):
                raise ValueError(f"argument on {x.device}; this plan runs "
                                 f"on {self.device}")
            if x.dtype != dt:
                raise ValueError(f"argument dtype {x.dtype}, traced {dt}")

    # -- observability ----------------------------------------------------------
    def explain(self, env: Optional[Dict[str, int]] = None) -> str:
        """Human-readable compile report: phase spans, decision log,
        per-slot symbolic sizes + liveness intervals, frozen-vs-runtime
        remat decisions, kernel selections, bucket table — and, when
        ``env`` is given, the plan-vs-actual memory timeline diff at that
        dim binding."""
        from .obs.explain import build_explain
        return build_explain(self, env=env)

    def memory_timeline(self, env: Mapping[str, int]):
        """Plan-vs-actual :class:`~repro_torch.core.obs.timeline.TimelineDiff`
        at one env: reconstructed actual arena occupancy over the program
        counter, diffed against the plan's predicted occupancy (VM
        executor only — the reference interpreter has no lowered stream).
        Uses the env's bucket Program when one is resident."""
        from .obs.timeline import diff_timeline
        env = dict(env)
        prog = self._program
        if self._table is not None:
            bp = self._table.peek(self._table.key_of(env))
            if bp is not None and bp.program is not None:
                prog = bp.program
        if prog is None:
            raise ValueError(
                'memory_timeline requires executor="vm" (no lowered '
                "Program under the reference interpreter)")
        return diff_timeline(prog, env)

    def enable_telemetry(self, capacity: int = 256,
                         sample_timeline_every: int = 0) -> Telemetry:
        """Attach a per-call telemetry ring (see
        :class:`repro_torch.core.obs.Telemetry`).
        ``sample_timeline_every=N`` additionally reconstructs the exact
        per-instruction memory timeline of every N-th call (off the hot
        path, VM executor only).  Returns the live aggregate; read it any
        time, detach with :meth:`disable_telemetry`."""
        self._telemetry = Telemetry(
            capacity=capacity, sample_timeline_every=sample_timeline_every)
        return self._telemetry

    def disable_telemetry(self) -> Optional[Telemetry]:
        """Detach and return the telemetry aggregate (``None`` if off).
        The hot path reverts to the single disabled-check immediately."""
        tel, self._telemetry = self._telemetry, None
        return tel

    @property
    def telemetry(self) -> Optional[Telemetry]:
        return self._telemetry

    # -- resilience --------------------------------------------------------------
    @property
    def resilience(self) -> Optional[ResilienceController]:
        """The attached resilience controller (``None`` when disabled)."""
        return self._resilience

    def enable_resilience(self, config: Optional[ResilienceConfig] = None
                          ) -> ResilienceController:
        """Attach the degradation ladder (see :class:`ResilienceConfig`).

        Calls then route through ``_call_resilient``: runtime failures
        walk retry-transient → retry-fallback → structured
        :class:`RequestFailed` instead of escaping raw.  Returns the live
        controller (counters, recent events); detach with
        :meth:`disable_resilience` — the hot path reverts to the single
        disabled check immediately.  ``enforce_arena_bound`` takes effect
        only through ``optimize(resilience=...)``, which bakes each
        plan's cap into its executor."""
        self._resilience = ResilienceController(
            config, fault_ref=self._fault_ref, decisions=self.decisions)
        self._resilience_config = self._resilience.config
        return self._resilience

    def disable_resilience(self) -> Optional[ResilienceController]:
        """Detach and return the controller (``None`` if off)."""
        res, self._resilience = self._resilience, None
        return res

    @contextmanager
    def inject_faults(self, plan: FaultPlan):
        """Install a :class:`FaultPlan` for the duration of the block.

        Enables a default-config resilience controller if none is
        attached (and detaches it again on exit); the previously
        installed plan is restored either way.  Yields the active
        controller so the block can read counters/events directly."""
        prev_plan = self._fault_ref.plan
        attached = self._resilience is None
        if attached:
            self.enable_resilience()
        self._fault_ref.plan = plan
        try:
            yield self._resilience
        finally:
            self._fault_ref.plan = prev_plan
            if attached:
                self._resilience = None

    @property
    def program(self) -> Optional[Program]:
        """The lowered Program (``None`` under ``executor="reference"``).
        With ``buckets=...`` this is the whole-range plan's Program;
        per-bucket Programs live on the specialization table's
        ``BucketPlan.program``."""
        return self._program

    # -- bucketed specialization ------------------------------------------------
    @property
    def specialization_table(self) -> Optional[SpecializationTable]:
        """The per-bucket plan cache (``None`` without ``buckets=...``)."""
        return self._table

    def warmup(self, envs: Iterable[Mapping[str, int]]) -> List[BucketKey]:
        """Compile the buckets containing ``envs`` before serving traffic.

        Synchronous, idempotent, runs nothing — it only specializes plans
        so first-request latency does not pay the compile.  ``envs`` is an
        iterable of dim bindings (a single mapping is also accepted);
        returns the distinct bucket keys now resident.
        """
        if self._table is None:
            raise ValueError(
                "warmup() requires bucketed dispatch — pass "
                "optimize(..., buckets=...)")
        if isinstance(envs, Mapping):
            envs = [envs]
        return self._table.warmup(envs)

    def drain_specializations(self, timeout: Optional[float] = None
                              ) -> List[BucketKey]:
        """Block until every in-flight background specialization lands.

        The deterministic join for ``background_specialize=True``: after it
        returns, every bucket that traffic has touched is compiled and the
        table's ``specialize_count`` matches what synchronous specialization
        would have produced.  Returns the bucket keys that completed while
        draining; a no-op (empty list) without bucketed dispatch or with
        nothing in flight."""
        if self._table is None:
            return []
        for t in list(self._remeasure_threads):
            t.join(timeout)
            if not t.is_alive():
                self._remeasure_threads.remove(t)
        return self._table.drain_background(timeout=timeout)

    # -- kernel-variant measured fallback ---------------------------------------
    def _maybe_remeasure(self, key: Optional[BucketKey],
                         env: Dict[str, int]) -> None:
        """Auto-trigger: after ``kernel_remeasure_after`` calls land in a
        bucket, time the variant candidates at that bucket's traffic shape
        and re-select — once per bucket.  Runs off-thread on a background
        table (the compile lock serializes the swap); inline otherwise."""
        n = self._kernel_calls.get(key, 0) + 1
        self._kernel_calls[key] = n
        if key in self._kernel_measured or n < self._kernel_remeasure_after:
            return
        if not self.plan.kernel_selections:
            return
        self._kernel_measured.add(key)
        if self._table is not None and self._table.background:
            t = threading.Thread(
                target=lambda: self.remeasure_kernels(env),
                name="kernel-remeasure", daemon=True)
            self._remeasure_threads.append(t)
            t.start()
        else:
            self.remeasure_kernels(env)

    def remeasure_kernels(self, env: Optional[Mapping[str, int]] = None, *,
                          repeats: int = 3) -> Dict[int, str]:
        """Measured fallback for kernel-variant selection.

        Times every variant of every kernel node that is valid at the
        concrete dim binding ``env`` (default: the most recent call's) on
        this plan's device, forces the per-node winners — restricted to
        variants that stay valid over the *whole* target range, so the
        swapped plan keeps the fallback-safety property — and rebuilds the
        plan: the env's bucket plan under bucketed dispatch (atomically
        swapped via the table), else the monolithic plan.  Returns node id
        -> winning variant name; the timings land on the new plan's
        :class:`~repro_torch.kernels.variants.KernelSelection`\\ s
        (``measured_s``).
        """
        from ..kernels.hw_model import DEFAULT_HW
        from ..kernels.variants import (measure_variants, node_bounds,
                                        select_kernels, variant_valid,
                                        variants_for)
        if env is None:
            if self.last_report is None:
                raise ValueError(
                    "remeasure_kernels needs an env (no call recorded yet)")
            env = self.last_report.env
        env = dict(env)
        if not self.plan.kernel_selections:
            return {}
        hw = self._hw if self._hw is not None else DEFAULT_HW
        key = None
        sg = self.plan.shape_graph
        if self._table is not None:
            key = self._table.key_of(env)
            sg = sg.specialized(self._table.space.ranges_of(key))
        forced: Dict[int, str] = {}
        timings: Dict[int, Dict[str, float]] = {}
        for nid, sel in self.plan.kernel_selections.items():
            node = self.plan.node_by_id[nid]
            timings[nid] = measure_variants(sel.prim_name, node, env, hw,
                                            repeats=repeats,
                                            device=self.device)
            # the winner must stay valid at the target range's hi corner,
            # not just at this env — never trade safety for speed
            hi = {k: h for k, (_lo, h) in node_bounds(node, sg).items()}
            dtype = node.invals[0].dtype
            by_name = {v.name: v for v in variants_for(sel.prim_name)}
            ranked = sorted(timings[nid].items(), key=lambda kv: kv[1])
            for name, _t in ranked:
                if variant_valid(sel.prim_name, by_name[name], hi, dtype, hw):
                    forced[nid] = name
                    break
            self.decisions.add(
                "kernel-measure", f"%{nid} {sel.prim_name}",
                forced.get(nid, sel.variant.name),
                f"measured best-of-{repeats} at "
                + " ".join(f"{k}={v}" for k, v in sorted(env.items())),
                timings_us={k: round(v * 1e6, 1) for k, v in ranked},
                bucket=key)
        if self._table is not None:
            self._kernel_forced[key] = forced
            plan = self._table.recompile(key).plan
        else:
            self.plan.kernel_selections = select_kernels(
                self.plan.graph, sg, hw, forced=forced,
                decisions=self.decisions)
            self.plan.kernel_overrides = {
                nid: s.variant.overrides()
                for nid, s in self.plan.kernel_selections.items()}
            self.interp, self._program = _build_executor(
                self.plan, self.report, self.executor,
                memory_limit=self.memory_limit,
                donate_inputs=self._donate_inputs,
                count_inputs=self._count_inputs, tracer=self.trace,
                arena_hard_cap=self.interp.arena_hard_cap)
            plan = self.plan
        for nid, sel in plan.kernel_selections.items():
            sel.measured_s = timings.get(nid, {})
        return forced

    @property
    def guaranteed_peak_bytes(self) -> Optional[int]:
        """Compile-time worst-case peak over the declared dim ranges.

        ``None`` unless every symbolic dim was given an upper bound via
        ``optimize(..., dynamic_dims=...)``.  For every call whose dims lie
        within the declared ranges, the device peak is <= this.  With
        ``buckets=...`` each bucket's own bound is tighter:
        ``specialization_table.peek(key).report.peak_bound_bytes``."""
        return self.report.peak_bound_bytes

    @property
    def arena_plan(self) -> Optional[ArenaPlan]:
        return self.plan.arena_plan

    @property
    def arena_bound_bytes(self) -> Optional[int]:
        """Compile-time worst-case planned arena size over the declared dim
        ranges (``None`` without ``memory_plan="arena"`` + bounded dims).
        Per-bucket bounds are tighter: see
        ``specialization_table.arena_bound_bytes(key)``."""
        return self.report.arena_bound_bytes

    def with_memory_limit(self, limit: Optional[int]
                          ) -> "DynamicShapeFunction":
        """The same plan under another memory limit, without retracing:
        only the lowering re-runs, because the limit decides whether the
        evict path is emitted.  A bucketed function keeps bucketing (its
        buckets re-lower under the new limit as traffic reaches them)."""
        table = self._table_factory(limit) if self._table_factory else None
        return DynamicShapeFunction(
            self.plan, self.report, device=self.device, memory_limit=limit,
            donate_inputs=self._donate_inputs,
            count_inputs=self._count_inputs, executor=self.executor,
            table=table, table_factory=self._table_factory,
            kernel_forced=self._kernel_forced,
            kernel_remeasure_after=self._kernel_remeasure_after, hw=self._hw,
            tracer=self.trace, decisions=self.decisions,
            resilience_config=self._resilience_config,
            fault_ref=self._fault_ref)


def optimize(fn: Callable, *specs,
             dynamic_dims: Optional[Dict[str, Any]] = None,
             enable_scheduling: bool = True,
             enable_remat: bool = True,
             memory_limit: Optional[int] = None,
             memory_plan: str = "arena",
             donate_inputs: bool = False,
             count_inputs: bool = True,
             max_subgraph: int = 24,
             guard_env: Optional[Dict[str, int]] = None,
             buckets: Optional[BucketsSpec] = None,
             max_cached_plans: int = 16,
             background_specialize: bool = False,
             executor: str = "vm",
             kernel_select: bool = True,
             kernel_remeasure_after: Optional[int] = None,
             device: Any = None,
             resilience: Union[ResilienceConfig, bool, None] = None,
             fault_plan: Optional[FaultPlan] = None
             ) -> DynamicShapeFunction:
    """Capture ``fn`` symbolically and build the optimized dynamic-shape plan.

    ``specs``: pytrees of :class:`TensorSpec` (dims are ints or the
    ``SymDim``s of :func:`symbolic_dims`), one per positional argument.
    ``dynamic_dims``: declared ranges per symbolic dim name — e.g.
    ``{"b": (1, 64), "s": "<=4096"}`` — feeding the interval fallback of
    symbolic comparisons; with every dim bounded above, the report carries
    a guaranteed worst-case peak (``guaranteed_peak_bytes``).
    ``guard_env``: representative dim binding used to verify the scheduled
    order does not regress peak memory vs the program order; defaults to
    all dims = 64, clamped into the declared ranges.
    ``memory_plan``: ``"arena"`` (default) runs the symbolic memory planner;
    ``"none"`` disables it.
    ``memory_limit``: device bytes a call may hold.  A call whose replayed
    peak fits runs the fast stream; one that does not runs the dynamic
    stream, which evicts remat candidates (offload to pinned host memory
    or drop for recompute, chosen per victim) and raises
    :class:`MemoryLimitExceeded` when nothing more can be evicted.
    ``enable_remat`` / ``max_subgraph``: run the recompute-subgraph search
    (subgraphs of at most ``max_subgraph`` nodes); without it the plan has
    no remat candidates, so the dynamic stream can evict nothing and a
    call whose peak exceeds ``memory_limit`` raises
    :class:`MemoryLimitExceeded`, as the reference's does.
    ``buckets``: partition the declared ranges into shape buckets and
    specialize the whole pipeline per bucket — ``"geometric"`` / an int
    count / a per-dim mapping ``{dim: count | [edges...]}`` (see
    :func:`repro_torch.core.dispatch.build_bucket_space`); requires
    ``dynamic_dims``.  Calls dispatch to their bucket's plan; buckets
    compile lazily on first use (or via :meth:`DynamicShapeFunction.warmup`)
    and at most ``max_cached_plans`` stay resident (LRU).
    ``background_specialize``: with ``buckets=``, a bucket miss no longer
    compiles on the request thread — the request is served immediately by
    the whole-range fallback plan (valid for any in-range env) while a
    background worker runs the bucket's pipeline and atomically swaps the
    compiled plan into the table; join deterministically via
    :meth:`DynamicShapeFunction.warmup` or
    :meth:`DynamicShapeFunction.drain_specializations`.
    ``executor``: ``"vm"`` (default) runs the lowered Program on the
    register VM; ``"reference"`` runs the op-by-op :class:`PlanInterpreter`
    (differential testing).
    ``kernel_select``: score the kernel variants of every kernel op
    (:mod:`repro_torch.kernels.variants`: the CUDA kernels and the plain
    version) over each plan's interval bounds on the card's cost model
    and bake the cheapest valid one into the lowered op call, as its
    ``impl``; per-bucket plans select per bucket, the whole-range plan
    keeps a variant valid anywhere in its range.  Selection overrides an
    ``impl`` the step passed (as the reference's does), so a plan that
    must run the plain version passes ``False``, which leaves every
    kernel op on its call-site ``impl``.
    ``kernel_remeasure_after``: measured fallback — after N calls land in
    a bucket, time the variant candidates at that traffic's shape and
    atomically swap a re-selected plan if the model mispredicted (see
    :meth:`DynamicShapeFunction.remeasure_kernels` for the manual form).
    ``device``: where the plan runs — ``cuda`` unless given (the tests pass
    ``"cpu"``); ``cuda`` without a card raises.  On ``cuda`` the cost
    model reads the card (``HardwareModel.from_device``); on the CPU it
    prices the published H100 constants.
    ``resilience``: attach the fault-tolerant call path — ``True`` for
    the default :class:`ResilienceConfig`, or a config instance.  Runtime
    failures then walk the degradation ladder (same-plan retry for
    transient faults, whole-range-fallback retry for memory pressure —
    ``MemoryLimitExceeded``, ``ArenaExhausted`` and, on the card, a real
    ``torch.cuda.OutOfMemoryError`` — and quarantined buckets, structured
    :class:`RequestFailed` when retries exhaust) instead of escaping raw;
    any other error propagates.  Bucket-compile failures quarantine
    behind a circuit breaker with exponential backoff while the fallback
    keeps serving.  ``None``/``False`` keeps the direct path (one
    attribute test per call).
    ``fault_plan``: install a deterministic
    :class:`~repro_torch.core.resilience.FaultPlan` (chaos testing);
    implies ``resilience=True`` when ``resilience`` is unset.  Swap plans
    later with :meth:`DynamicShapeFunction.inject_faults`.
    """
    if memory_plan not in ("arena", "none"):
        raise ValueError(
            f"memory_plan must be 'arena' or 'none', got {memory_plan!r}")
    if background_specialize and buckets is None:
        raise ValueError(
            "background_specialize=True requires bucketed dispatch — pass "
            "optimize(..., buckets=...)")
    if executor not in _EXECUTORS:
        raise ValueError(
            f"executor must be one of {_EXECUTORS}, got {executor!r}")
    if isinstance(resilience, ResilienceConfig):
        r_cfg: Optional[ResilienceConfig] = resilience
    elif resilience:
        r_cfg = ResilienceConfig()
    elif resilience is None and fault_plan is not None:
        r_cfg = ResilienceConfig()   # a fault plan implies the ladder
    else:
        r_cfg = None
    fault_ref = FaultPlanRef(fault_plan)
    dev = resolve_device(device)
    hw = None
    if kernel_select:
        from ..kernels.hw_model import DEFAULT_HW, HardwareModel
        hw = HardwareModel.from_device(dev) if dev.type == "cuda" \
            else DEFAULT_HW
    tracer = Tracer()
    decisions = DecisionLog()
    with tracer.span("trace") as _tsp:
        graph, guards = capture(fn, specs, device=dev, ranges=dynamic_dims)
        _tsp.attrs["n_nodes"] = len(graph.nodes)
    sg = ShapeGraph()
    if dynamic_dims:
        known = graph.free_symbols()
        unknown = sorted(set(dynamic_dims) - known)
        if unknown:
            raise ValueError(
                f"dynamic_dims names {unknown} are not symbolic dims of the "
                f"traced function (known: {sorted(known)})")
    declare_dim_ranges(sg, dynamic_dims)
    # value-dependent bounded dims: capture introduced fresh symbols with a
    # cap expression over input dims — declare each so interval/compare
    # queries answer through the cap without a user-declared range
    for bname, cap in graph.bound_dims.items():
        sg.declare_bound(bname, cap)
    knobs = dict(enable_scheduling=enable_scheduling,
                 enable_remat=enable_remat, max_subgraph=max_subgraph,
                 memory_plan=memory_plan, donate_inputs=donate_inputs,
                 count_inputs=count_inputs, guard_env=guard_env,
                 tracer=tracer, decisions=decisions,
                 kernel_select=kernel_select, hw=hw)
    # measured-fallback channel: bucket key -> {node id -> forced variant}.
    # remeasure_kernels fills it, then a table recompile re-runs the bucket
    # pipeline, whose selection honors the forced names
    kernel_forced: Dict[Optional[BucketKey], Dict[int, str]] = {}
    # collect the schedule/remat artifacts + their compare-key dependencies
    # so per-bucket specialization can re-run incrementally
    plan, report, artifacts = _compile_pipeline(
        graph, sg, collect=buckets is not None, **knobs)
    report.guards = guards

    table_factory = None
    if buckets is not None:
        # the bucket space spans declared (call-entry) dims only: bound dims
        # are measured mid-call, so dispatch can never key on them — each
        # bucket re-derives their caps from its narrowed ranges
        space = build_bucket_space(
            {k: v for k, v in sg.declared_ranges.items()
             if k not in graph.bound_dims}, buckets)
        report.buckets = space

        def _hard_cap(rep: OptimizeReport) -> Optional[int]:
            """Per-plan enforced cap under resilience.enforce_arena_bound:
            each executor is held to *its own* plan's guarantee."""
            if r_cfg is not None and r_cfg.enforce_arena_bound:
                return rep.arena_bound_bytes
            return None

        def table_factory(limit: Optional[int],
                          _space=space) -> SpecializationTable:
            def compile_bucket(key, ranges) -> BucketPlan:
                # chaos hook: an installed fault plan may schedule this
                # bucket's specialization to fail or hang (the breaker
                # quarantines it; the fallback keeps serving)
                fpl = fault_ref.plan
                if fpl is not None:
                    fpl.check_compile(key)
                # a background-worker compile shows up as its own root span
                # (the tracer's span stack is thread-local) tagged here, so
                # traces distinguish swap-in compiles from blocking ones
                bg = threading.current_thread().name.startswith("specialize")
                with tracer.span("specialize", bucket=key,
                                 background=bg) as sp:
                    sub_sg = sg.specialized(ranges)
                    b_plan, b_report, _ = _compile_pipeline(
                        graph, sub_sg, parent=artifacts,
                        kernel_forced=kernel_forced.get(key), **knobs)
                    runner, b_program = _build_executor(
                        b_plan, b_report, executor, memory_limit=limit,
                        donate_inputs=donate_inputs,
                        count_inputs=count_inputs, tracer=tracer,
                        arena_hard_cap=_hard_cap(b_report))
                    sp.attrs.update(
                        reused_parent_schedule=b_report.reused_parent_schedule,
                        reused_parent_postpass=b_report.reused_parent_postpass,
                        arena_bound_bytes=b_report.arena_bound_bytes)
                return BucketPlan(key=key, ranges=ranges, plan=b_plan,
                                  report=b_report, interp=runner,
                                  program=b_program)
            fallback = None
            if background_specialize:
                f_runner, f_program = _build_executor(
                    plan, report, executor, memory_limit=limit,
                    donate_inputs=donate_inputs, count_inputs=count_inputs,
                    tracer=tracer, arena_hard_cap=_hard_cap(report))
                fallback = BucketPlan(key=None,
                                      ranges=dict(sg.declared_ranges),
                                      plan=plan, report=report,
                                      interp=f_runner, program=f_program)
            return SpecializationTable(
                _space, compile_bucket, max_live=max_cached_plans,
                background=background_specialize, fallback=fallback,
                breaker=CircuitBreaker(r_cfg.breaker if r_cfg else None),
                compile_timeout_s=(r_cfg.compile_timeout_s
                                   if r_cfg else None))

    return DynamicShapeFunction(
        plan, report, device=dev, memory_limit=memory_limit,
        donate_inputs=donate_inputs, count_inputs=count_inputs,
        executor=executor,
        table=table_factory(memory_limit) if table_factory else None,
        table_factory=table_factory, kernel_forced=kernel_forced,
        kernel_remeasure_after=kernel_remeasure_after, hw=hw,
        tracer=tracer, decisions=decisions, resilience_config=r_cfg,
        fault_ref=fault_ref)
