"""ExecutionPlan -> Program compilation (the lowering pass).

One linear walk over the scheduled order turns every per-call decision
the ``PlanInterpreter`` re-derives op-by-op into static instruction
structure:

* **registers** — value ids renumbered densely in first-store order
  (inputs, consts, then scheduled outputs), so the VM indexes lists;
* **death points** — each value's last consumer position is known from
  the schedule, so frees become ``FreeSlot``/``Donate`` instructions
  instead of per-op refcount bookkeeping;
* **argument templates** — each op's arguments are pre-flattened, with
  the positions of its tensor inputs recorded, so a call is one list copy
  and one unflatten.  A kernel variant that selection chose for this plan
  is baked in here, as the ``impl`` argument of the node's op (the shared
  ``node.params`` stay untouched: other buckets' plans choose their own);
* **evict/regen guards** — ``MaybeEvict``/``Regen`` instructions are
  emitted only when eviction is actually possible: there is a memory
  limit, and the guaranteed worst-case peak (interval bounds over the
  declared dim ranges) does not already prove every in-range env fits
  under it.  With no limit — or a proven-safe one — the stream contains
  no runtime remat machinery at all;
* **regen sub-programs** — candidates' recompute subgraphs are lowered
  inline by ``repro_torch.core.remat.export.export_regen_programs``;
* **rolled loops** — a loop node lowers to one ``Loop`` instruction over
  its body, lowered once as a sub-``Program`` (with its inputs donated,
  so a carry's previous generation is released at its last use in the
  next iteration);
* **bounded dims** — an introducer's Compute is followed by a ``BindDim``
  that measures the dim and then makes the payload's deferred accounting
  alloc at the tight size.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..ir.capture import Arg, has_symbolic, override_template
from ..ir.graph import Value
from ..ir.loop import loop_body_of
from ..remat.export import export_regen_programs
from ..remat.planner import ExecutionPlan
from ..symbolic.expr import SymbolicExpr
from .program import (BindArg, BindDim, Compute, Donate, FreeSlot, Loop,
                      LoopInfo, MaybeEvict, Program, Regen, Return)


def lower_plan(plan: ExecutionPlan, *,
               memory_limit: Optional[int] = None,
               donate_inputs: bool = False,
               count_inputs: bool = True,
               peak_bound_bytes: Optional[int] = None) -> Program:
    """Compile ``plan`` into a flat :class:`Program`.

    ``peak_bound_bytes`` is the guaranteed worst-case free-run peak over
    the declared dim ranges (from ``simulate_peak_bound``); when it is
    known and ``<= memory_limit``, eviction is provably impossible and
    the evict path is not emitted.
    """
    g = plan.graph
    output_ids = {v.id for v in g.outputs}

    reg_of: Dict[int, int] = {}
    vid_of: List[int] = []
    nbytes_exprs = []

    def new_reg(v: Value) -> int:
        r = reg_of.get(v.id)
        if r is None:
            r = len(vid_of)
            reg_of[v.id] = r
            vid_of.append(v.id)
            nbytes_exprs.append(v.nbytes_expr)
        return r

    # eviction is possible only under a limit the bounds cannot clear
    has_evict_path = memory_limit is not None and (
        peak_bound_bytes is None or peak_bound_bytes > memory_limit)
    cands = plan.candidates if has_evict_path else {}

    def droppable(v: Value) -> bool:
        """An eviction can drop ``v``: a candidate or a view of one."""
        return v.id in cands or (v.base is not None and v.base.id in cands)

    instructions: List[Any] = []
    for i, v in enumerate(g.inputs):
        instructions.append(BindArg(reg=new_reg(v), index=i, const=None,
                                    vid=v.id))
    for v in g.consts:
        instructions.append(BindArg(reg=new_reg(v), index=-1,
                                    const=v.const_val, vid=v.id))

    # death point = last consumer position in the scheduled order
    death_pos: Dict[int, int] = {
        vid: uses[-1] for vid, uses in plan.use_positions.items() if uses}

    computes: List[Compute] = []
    static_leaves: List[Optional[List[Any]]] = []
    compute_of: Dict[int, Compute] = {}
    view_src: Dict[int, Tuple[Compute, int]] = {}
    views_of: Dict[int, List[int]] = {}
    loops: List[LoopInfo] = []
    for step, node in enumerate(plan.order):
        body = loop_body_of(node)
        pinned = frozenset(
            [iv.id for iv in node.invals] + [ov.id for ov in node.outvals])
        if has_evict_path:
            # roots first: a view rebuilds over its materialized root
            regen = [iv for iv in node.invals if iv.id in cands] + \
                [iv for iv in node.invals[:node.n_args]
                 if iv.base is not None and iv.base.id in cands]
            regen_regs = tuple(dict.fromkeys(reg_of[iv.id] for iv in regen))
            if regen_regs:
                instructions.append(Regen(regs=regen_regs, step=step,
                                          pinned=pinned))
            if body is None:
                # a rolled loop does its own hoisted ensure (the resolved
                # internal peak delta) inside the Loop handler
                instructions.append(MaybeEvict(cidx=len(computes), step=step,
                                               pinned=pinned))
        store = tuple((oi, new_reg(ov)) for oi, ov in enumerate(node.outvals)
                      if ov.consumers or ov.id in output_ids)
        if body is not None:
            # rolled loop: lower the captured body ONCE as a sub-Program —
            # the outer stream stays O(body) regardless of the trip count
            lp = body.plan(plan.shape_graph)
            body_plan = ExecutionPlan(graph=body.graph, order=list(lp.order),
                                      shape_graph=plan.shape_graph)
            body_program = lower_plan(body_plan, donate_inputs=True)
            kept = tuple(bool(ov.consumers) or ov.id in output_ids
                         for ov in node.outvals)
            instructions.append(Loop(
                lidx=len(loops),
                in_regs=tuple(reg_of[iv.id]
                              for iv in node.invals[:node.n_args]),
                store=store, step=step, pinned=pinned))
            loops.append(LoopInfo(node=node, body=body, lp=lp,
                                  body_program=body_program, kept=kept))
        else:
            intro = g.bound_intros.get(node.id)
            defer_regs: Tuple[int, ...] = ()
            extra_store: Tuple[Tuple[int, int], ...] = ()
            if intro is not None:
                # the payload's accounting alloc moves to the BindDim below
                # (its tight size needs the measured count); the count
                # scalar must reach a register either way
                defer_regs = tuple(r for oi, r in store
                                   if oi == intro.padded_out)
                count_reg = new_reg(node.outvals[intro.count_out])
                count_kept = any(oi == intro.count_out for oi, _r in store)
                if not count_kept:
                    extra_store = ((intro.count_out, count_reg),)
            leaves, spec = override_template(
                node, plan.kernel_overrides.get(node.id))
            comp = Compute(cidx=len(computes), node=node, prim=node.prim,
                           multi=bool(node.params["multi"]),
                           in_regs=tuple(reg_of[iv.id]
                                         for iv in node.invals[:node.n_args]),
                           arg_slots=tuple((li, x.i)
                                           for li, x in enumerate(leaves)
                                           if isinstance(x, Arg)),
                           spec=spec, store=store, template=tuple(leaves),
                           defer_regs=defer_regs, extra_store=extra_store)
            instructions.append(comp)
            computes.append(comp)
            compute_of[node.id] = comp
            static_leaves.append(None if has_symbolic(leaves) else leaves)
            for oi, r in store:
                ov = node.outvals[oi]
                if droppable(ov) and ov.base is not None:
                    view_src[r] = (comp, oi)
                    views_of.setdefault(reg_of[ov.base.id], []).append(r)
            if intro is not None:
                instructions.append(BindDim(
                    name=intro.name, cap_expr=intro.cap, count_reg=count_reg,
                    alloc_store=tuple((oi, r) for oi, r in store
                                      if r in defer_regs),
                    drop_count=not count_kept, step=step,
                    payload_reg=next((r for oi, r in store
                                      if oi == intro.padded_out), -1),
                    axis=intro.axis))

        # frees, in first-occurrence order
        seen = set()
        for iv in node.invals:
            if iv.id in seen:
                continue
            seen.add(iv.id)
            if death_pos.get(iv.id) != step or iv.id in output_ids:
                continue
            if iv.is_materialized_input():
                if donate_inputs:
                    instructions.append(Donate(reg=reg_of[iv.id], vid=iv.id,
                                               counted=count_inputs))
            else:
                instructions.append(FreeSlot(reg=reg_of[iv.id], vid=iv.id))

    out_regs = tuple(reg_of[v.id] for v in g.outputs)
    instructions.append(Return(regs=out_regs))

    regen_programs = {}
    candidate_regs: Tuple[int, ...] = ()
    if has_evict_path:
        regen_programs = export_regen_programs(plan, reg_of, compute_of)
        candidate_regs = tuple(sorted(
            reg_of[vid] for vid in plan.candidates if vid in reg_of))

    death_step = [-1] * len(vid_of)
    for vid, pos in death_pos.items():
        r = reg_of.get(vid)
        if r is not None:
            death_step[r] = pos

    fast = [inst for inst in instructions
            if inst.op not in (Regen.op, MaybeEvict.op)]

    # bounded dim -> every register whose byte size mentions it, and every
    # Compute whose arguments do; the BindDim publishing that dim
    # refreshes exactly these
    bound_dep_regs: Dict[str, Tuple[int, ...]] = {}
    bound_dep_cidx: Dict[str, Tuple[int, ...]] = {}
    for name in g.bound_dims:
        bound_dep_regs[name] = tuple(
            r for r, e in enumerate(nbytes_exprs) if name in e.free_vars())
        bound_dep_cidx[name] = tuple(
            c.cidx for c in computes
            if any(isinstance(x, SymbolicExpr) and name in x.free_vars()
                   for x in c.template))

    return Program(plan=plan, graph=g, n_regs=len(vid_of), reg_of=reg_of,
                   vid_of=vid_of, nbytes_exprs=nbytes_exprs,
                   instructions=instructions, fast_instructions=fast,
                   computes=computes, static_leaves=static_leaves,
                   out_regs=out_regs, donate_inputs=donate_inputs,
                   count_inputs=count_inputs, regen=regen_programs,
                   death_step=death_step, candidate_regs=candidate_regs,
                   view_src=view_src,
                   views_of={r: tuple(vs) for r, vs in views_of.items()},
                   has_evict_path=has_evict_path, memory_limit=memory_limit,
                   loops=loops, bound_dep_regs=bound_dep_regs,
                   bound_dep_cidx=bound_dep_cidx)
