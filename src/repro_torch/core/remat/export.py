"""Export the remat analysis to the executable paths.

Two consumers, as in the reference (``repro/core/remat/export.py``):

* the lowered runtime — :func:`export_regen_programs` turns each
  candidate's recompute subgraph into a register-addressed
  ``RegenProgram`` the ``ProgramVM`` runs inline (the paper's
  ``Remat::RegenerateOp``, compiled instead of interpreted);
* the compiled path — :func:`recommend_policy` derives which checkpoint
  policy the layer stack (``ModelConfig.remat_policy``, each block under
  ``torch.utils.checkpoint``) should use from the §2.3 search results
  (how much of the block is cheap to recompute).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Dict, Optional

import torch

from ..remat.planner import ExecutionPlan
from ..remat.search import node_flops
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


# products with no batch dims: their outputs are what
# ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` saves
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_saveable(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy for
    ``torch.utils.checkpoint.create_selective_checkpoint_contexts``: save
    the outputs of the products with no batch dims (``aten.mm``,
    ``aten.addmm``: every ``x @ w`` with a 2-D weight), recompute the rest
    (``bmm``, the flash op, the elementwise chains), as
    ``dots_with_no_batch_dims_saveable`` does in the reference."""
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


@dataclass
class RematRecommendation:
    policy_name: str              # 'block' | 'dots_saveable' | 'none'
    policy: Optional[Callable]    # selective-checkpoint policy (None = block)
    recompute_flop_fraction: float
    recomputable_byte_fraction: float
    rationale: str


def recommend_policy(plan: ExecutionPlan, env: Dict[str, int],
                     *, memory_headroom: float = 0.25) -> RematRecommendation:
    """Pick the layer stack's checkpoint policy from the §2.3 search
    results (``repro/core/remat/export.py:87``: the same heuristic,
    thresholds and rationale).

    If most candidate bytes are cheaply recomputable (elementwise-dominated
    regeneration subgraphs), full block remat is nearly free — 'block'.  If
    regeneration cost concentrates in matmuls, saving the products'
    outputs trades memory for FLOPs — 'dots_saveable' (:func:`dots_saveable`)
    only when there is HBM headroom to spend."""
    total_flops = sum(node_flops(n).evaluate(env)
                      for n in plan.graph.nodes) or 1
    recomp_flops = 0
    recomp_bytes = 0
    total_bytes = 0
    for cand in plan.candidates.values():
        b = cand.value.nbytes_expr.evaluate(env)
        total_bytes += b
        if cand.recompute is not None:
            recomp_bytes += b
            recomp_flops += cand.recompute.flops.evaluate(env)
    flop_frac = recomp_flops / total_flops
    byte_frac = recomp_bytes / max(total_bytes, 1)

    if byte_frac >= 0.5 and flop_frac <= 0.35:
        return RematRecommendation(
            "block", None, flop_frac, byte_frac,
            f"{byte_frac:.0%} of candidate bytes regenerate for "
            f"{flop_frac:.0%} of step FLOPs: full block remat is cheap")
    if memory_headroom >= 0.3:
        return RematRecommendation(
            "dots_saveable", dots_saveable, flop_frac, byte_frac,
            "regeneration is matmul-heavy and HBM headroom exists: save "
            "dot outputs, recompute the elementwise chains")
    return RematRecommendation(
        "block", None, flop_frac, byte_frac,
        "matmul-heavy regeneration but no HBM headroom: block remat")
