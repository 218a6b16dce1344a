"""ExecutionPlan -> Program compilation (the lowering pass).

One linear walk over the scheduled order turns per-call bookkeeping into
static instruction structure:

* **registers** — value ids renumbered densely in first-store order
  (inputs, consts, then scheduled outputs), so the VM indexes lists;
* **death points** — each value's last consumer position is known from
  the schedule, so frees become ``FreeSlot``/``Donate`` instructions
  instead of per-op refcount bookkeeping;
* **argument templates** — each op's arguments are pre-flattened, with
  the positions of its tensor inputs recorded, so a call is one list copy
  and one unflatten.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..ir.capture import Arg, has_symbolic
from ..ir.graph import Value
from ..remat.planner import ExecutionPlan
from .program import BindArg, Compute, Donate, FreeSlot, Program, Return


def lower_plan(plan: ExecutionPlan, *,
               donate_inputs: bool = False,
               count_inputs: bool = True) -> Program:
    """Compile ``plan`` into a flat :class:`Program`."""
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
    for step, node in enumerate(plan.order):
        store = tuple((oi, new_reg(ov)) for oi, ov in enumerate(node.outvals)
                      if ov.consumers or ov.id in output_ids)
        leaves = node.params["leaves"]
        comp = Compute(cidx=len(computes), node=node, prim=node.prim,
                       multi=bool(node.params["multi"]),
                       in_regs=tuple(reg_of[iv.id]
                                     for iv in node.invals[:node.n_args]),
                       arg_slots=tuple((li, x.i) for li, x in enumerate(leaves)
                                       if isinstance(x, Arg)),
                       spec=node.params["spec"], store=store)
        instructions.append(comp)
        computes.append(comp)
        static_leaves.append(None if has_symbolic(leaves) else list(leaves))

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

    return Program(plan=plan, graph=g, n_regs=len(vid_of), reg_of=reg_of,
                   vid_of=vid_of, nbytes_exprs=nbytes_exprs,
                   instructions=instructions, computes=computes,
                   static_leaves=static_leaves, out_regs=out_regs,
                   donate_inputs=donate_inputs,
                   count_inputs=count_inputs)
