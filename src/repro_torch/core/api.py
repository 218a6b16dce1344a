"""Public API of the BladeDISC++-style memory optimizer (PyTorch port).

    B, S = symbolic_dims("b, s")
    opt = optimize(step, params_spec, {"tokens": TensorSpec((B, S), torch.int32)},
                   dynamic_dims={"b": (1, 8), "s": (16, 1024)})
    out = opt(params, batch)                  # any (b, s) in range, no retrace
    opt.last_report.stats.device_peak         # exact planned peak bytes

``optimize`` performs the paper's pipeline once at "compile" time:
symbolic capture → symbolic shape graph → op scheduling (§2.2) → memory
planning → lowering to a flat ``Program``.  Calls then execute through the
register ``ProgramVM`` on the plan's device.

Not ported yet, and refused with ``NotImplementedError``: the
rematerialization search with ``memory_limit``, bucketed dispatch, the
reference interpreter, kernel-variant selection, resilience and telemetry.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from .executor.vm import ProgramVM, RunReport
from .ir.capture import (TensorSpec, capture, check_declared_ranges,
                         solve_env, spec_like, symbolic_dims)
from .lowering import Program, lower_plan
from .memplan import ArenaPlan, build_arena_plan
from .remat.planner import ExecutionPlan, build_plan
from .scheduling.exchange import exchange_pass
from .scheduling.memsim import simulate_peak, simulate_peak_bound
from .scheduling.scheduler import ScheduleResult, schedule_graph
from .symbolic import ShapeGraph, declare_dim_ranges

__all__ = ["optimize", "DynamicShapeFunction", "OptimizeReport",
           "TensorSpec", "symbolic_dims", "spec_like", "resolve_device"]

# knobs of the reference ``optimize`` that later parts of the port bring
_NOT_PORTED = ("memory_limit", "enable_remat", "max_subgraph", "buckets",
               "max_cached_plans", "background_specialize", "executor",
               "kernel_select", "kernel_remeasure_after", "resilience",
               "fault_plan")


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another; asking for ``cuda`` without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@dataclass
class OptimizeReport:
    schedule: ScheduleResult
    used_scheduled_order: bool
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


def _compile_pipeline(graph, sg: ShapeGraph, *,
                      enable_scheduling: bool = True,
                      memory_plan: str = "arena",
                      donate_inputs: bool = False,
                      count_inputs: bool = True,
                      guard_env: Optional[Dict[str, int]] = None,
                      ) -> Tuple[ExecutionPlan, OptimizeReport]:
    """schedule → memplan → bounds over an already-captured graph."""

    def _clamp(name: str, v: int) -> int:
        iv = sg.declared_ranges.get(name)
        if iv is None:
            return v
        if iv.lo is not None:
            v = max(v, iv.lo)
        if iv.hi is not None:
            v = min(v, iv.hi)
        return v

    used_sched = False
    if enable_scheduling:
        sched = schedule_graph(graph, sg)
        free_syms = graph.free_symbols()
        env = dict(guard_env) if guard_env else {n: 64 for n in free_syms}
        for name in free_syms:
            env.setdefault(name, 64)
        env = {k: _clamp(k, v) for k, v in env.items()}
        probe_envs = [env,
                      {k: _clamp(k, max(1, v // 4)) for k, v in env.items()},
                      {k: _clamp(k, v * 4) for k, v in env.items()}]
        # best-of safeguard: never keep an order that regresses the
        # program order's peak at the guard env
        base = simulate_peak(graph, graph.nodes, env,
                             count_inputs=count_inputs)
        tuned = simulate_peak(graph, sched.order, env,
                              count_inputs=count_inputs)
        used_sched = tuned.peak_bytes <= base.peak_bytes
        kept_peak = min(tuned.peak_bytes, base.peak_bytes)
        if not used_sched:
            sched = ScheduleResult(list(graph.nodes), sched.symbolic_decisions,
                                   sched.tiebreak_decisions)
        # pairwise-exchange refinement, guarded at the probe envs
        refined = exchange_pass(graph, sched.order, probe_envs)
        refined_peak = simulate_peak(graph, refined, env,
                                     count_inputs=count_inputs).peak_bytes
        if refined_peak <= kept_peak:
            sched = ScheduleResult(refined, sched.symbolic_decisions,
                                   sched.tiebreak_decisions)
    else:
        sched = ScheduleResult(list(graph.nodes), 0, 0)

    arena_plan = None
    if memory_plan == "arena":
        arena_plan = build_arena_plan(graph, sched.order, sg,
                                      donate_inputs=donate_inputs)
    plan = build_plan(graph, sched, sg, arena_plan=arena_plan)
    peak_lo = peak_hi = None
    if sg.declared_ranges:  # without ranges the bound is vacuous (hi = None)
        peak_lo, peak_hi = simulate_peak_bound(
            graph, sched.order, sg, count_inputs=count_inputs,
            donate_inputs=donate_inputs)
    report = OptimizeReport(schedule=sched, used_scheduled_order=used_sched,
                            peak_bound_bytes=peak_hi, peak_bound_lo=peak_lo,
                            cmp_stats=dict(sg.cmp_stats))
    if arena_plan is not None:
        report.arena_bound_bytes = arena_plan.arena_bound_bytes
        report.n_arena_slots = arena_plan.n_slots
        report.n_provable_reuses = arena_plan.n_provable_reuses
        report.n_checked_reuses = arena_plan.n_checked_reuses
    return plan, report


class DynamicShapeFunction:
    """A compiled-once, run-any-shape callable with memory optimization."""

    def __init__(self, plan: ExecutionPlan, report: OptimizeReport, *,
                 device: torch.device, donate_inputs: bool = False,
                 count_inputs: bool = True):
        self.plan = plan
        self.report = report
        self.device = device
        self._program = lower_plan(plan, donate_inputs=donate_inputs,
                                   count_inputs=count_inputs)
        self.interp = ProgramVM(self._program)
        self.last_report: Optional[RunReport] = None
        graph = plan.graph
        self._in_tree = graph.in_tree
        self._out_tree = graph.out_tree
        self._in_dtypes = [v.dtype for v in graph.inputs]

    def __call__(self, *args):
        flat, in_tree = pytree.tree_flatten(tuple(args))
        if in_tree != self._in_tree:
            raise TypeError(f"pytree structure mismatch: traced "
                            f"{self._in_tree}, got {in_tree}")
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
        env = solve_env(self.plan.graph, flat)
        check_declared_ranges(self.plan.shape_graph, env)
        outs, report = self.interp.run(flat, env=env)
        self.last_report = report
        return pytree.tree_unflatten(outs, self._out_tree)

    @property
    def program(self) -> Program:
        return self._program

    @property
    def guaranteed_peak_bytes(self) -> Optional[int]:
        """Compile-time worst-case peak over the declared dim ranges.

        ``None`` unless every symbolic dim was given an upper bound via
        ``optimize(..., dynamic_dims=...)``.  For every call whose dims lie
        within the declared ranges, the device peak is <= this."""
        return self.report.peak_bound_bytes

    @property
    def arena_plan(self) -> Optional[ArenaPlan]:
        return self.plan.arena_plan

    @property
    def arena_bound_bytes(self) -> Optional[int]:
        """Compile-time worst-case planned arena size over the declared dim
        ranges (``None`` without ``memory_plan="arena"`` + bounded dims)."""
        return self.report.arena_bound_bytes


def optimize(fn: Callable, *specs,
             dynamic_dims: Optional[Dict[str, Any]] = None,
             enable_scheduling: bool = True,
             memory_plan: str = "arena",
             donate_inputs: bool = False,
             count_inputs: bool = True,
             guard_env: Optional[Dict[str, int]] = None,
             device: Any = None,
             **later: Any) -> DynamicShapeFunction:
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
    ``device``: where the plan runs — ``cuda`` unless given (the tests pass
    ``"cpu"``); ``cuda`` without a card raises.
    """
    if later:
        unknown = sorted(set(later) - set(_NOT_PORTED))
        if unknown:
            raise TypeError(f"optimize() got unexpected arguments {unknown}")
        raise NotImplementedError(
            f"optimize({', '.join(sorted(later))}=...) is not ported to "
            f"PyTorch yet")
    if memory_plan not in ("arena", "none"):
        raise ValueError(
            f"memory_plan must be 'arena' or 'none', got {memory_plan!r}")
    dev = resolve_device(device)
    graph, guards = capture(fn, specs, device=dev, ranges=dynamic_dims)
    sg = ShapeGraph()
    if dynamic_dims:
        known = graph.free_symbols()
        unknown = sorted(set(dynamic_dims) - known)
        if unknown:
            raise ValueError(
                f"dynamic_dims names {unknown} are not symbolic dims of the "
                f"traced function (known: {sorted(known)})")
    declare_dim_ranges(sg, dynamic_dims)
    plan, report = _compile_pipeline(
        graph, sg, enable_scheduling=enable_scheduling,
        memory_plan=memory_plan, donate_inputs=donate_inputs,
        count_inputs=count_inputs, guard_env=guard_env)
    report.guards = guards
    return DynamicShapeFunction(plan, report, device=dev,
                                donate_inputs=donate_inputs,
                                count_inputs=count_inputs)
