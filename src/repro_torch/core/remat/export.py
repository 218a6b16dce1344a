"""Export the remat analysis to the lowered runtime.

Port of ``export_regen_programs`` (``repro/core/remat/export.py:29``):
each candidate's recompute subgraph becomes a register-addressed
``RegenProgram`` that the ``ProgramVM`` runs inline (the paper's
``Remat::RegenerateOp``, compiled instead of interpreted).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict

from ..remat.planner import ExecutionPlan
from ..symbolic import ZERO

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..lowering.program import Compute, RegenProgram


def export_regen_programs(plan: ExecutionPlan, reg_of: Dict[int, int],
                          compute_of: Dict[int, "Compute"],
                          ) -> Dict[int, "RegenProgram"]:
    """Lower every candidate's recompute subgraph over VM registers.

    ``reg_of`` maps value ids to the main program's dense registers,
    ``compute_of`` maps node ids to their main-program ``Compute`` (the
    sub-program reuses its per-env resolved argument leaves — no second
    resolve).  Returns ``{target register: RegenProgram}`` with
    sub-program-local temps for values produced inside the subgraph and
    main registers (materialized recursively at runtime) for the
    subgraph's sources.
    """
    from ..lowering.program import RegenProgram, RegenStep

    out: Dict[int, RegenProgram] = {}
    for vid, cand in plan.candidates.items():
        rp = cand.recompute
        if rp is None:
            continue
        temp_of: Dict[int, int] = {}
        steps = []
        for nid in rp.node_ids:
            node = plan.node_by_id[nid]
            comp = compute_of[nid]
            in_refs = []
            for iv in node.invals[:node.n_args]:
                t = temp_of.get(iv.id)
                in_refs.append((True, t) if t is not None
                               else (False, reg_of[iv.id]))
            writes = []
            out_bytes = ZERO
            for oi, ov in enumerate(node.outvals):
                writes.append((oi, temp_of.setdefault(ov.id, len(temp_of))))
                out_bytes = out_bytes + ov.nbytes_expr
            steps.append(RegenStep(
                node=node, prim=node.prim, multi=comp.multi, cidx=comp.cidx,
                arg_slots=comp.arg_slots, spec=comp.spec,
                in_refs=tuple(in_refs), writes=tuple(writes),
                out_bytes=out_bytes))
        out[reg_of[vid]] = RegenProgram(
            target_reg=reg_of[vid], target_vid=vid,
            source_regs=tuple(reg_of[s] for s in rp.source_ids),
            n_temps=len(temp_of), steps=tuple(steps),
            target_temp=temp_of[vid], flops_expr=rp.flops)
    return out
