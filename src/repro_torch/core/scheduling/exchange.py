"""Pairwise-exchange post-pass over a schedule (beyond-paper refinement).

The greedy list scheduler (§2.2) is myopic; a classic strengthening is
bubble-style adjacent exchange: swap two neighbouring, *independent* ops
when doing so lowers the local memory peak.  Locality makes the test
exact and O(1): for [n1, n2] from usage U,

    peak = max(U + a1, U + a1 - f1 + a2)

and after the swap ``max(U + a2, U + a2 - f2 + a1)``; frees are
order-invariant when the pair shares no operands.  We require improvement
at every probe env (several dim bindings), so the exchange, like the rest
of the pipeline, is decided once and holds for all shapes.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from ..ir.graph import Graph, Node


def _node_effects(g: Graph, order: Sequence[Node], env: Dict[str, int],
                  nbytes: Dict[int, int] = None):
    """Per-node (alloc_bytes, freed_bytes) under `order` at `env`."""
    output_ids = {v.id for v in g.outputs}
    pos = {n.id: i for i, n in enumerate(order)}
    remaining = {v.id: sum(1 for c in v.consumers if c.id in pos)
                 for v in g.values}
    if nbytes is None:
        nbytes = {v.id: v.nbytes_expr.evaluate(env) for v in g.values}
    alloc, freed = [], []
    for n in order:
        a = sum(nbytes[ov.id] for ov in n.outvals
                if ov.consumers or ov.id in output_ids)
        f = 0
        seen = set()
        for iv in n.invals:
            if iv.id in seen:
                continue
            seen.add(iv.id)
            mult = sum(1 for x in n.invals if x.id == iv.id)
            remaining[iv.id] -= mult
            if remaining[iv.id] == 0 and not iv.is_materialized_input() \
                    and iv.id not in output_ids:
                f += nbytes[iv.id]
        alloc.append(a)
        freed.append(f)
    return alloc, freed


def _independent(n1: Node, n2: Node) -> bool:
    """True if swapping n1,n2 is legal and their frees are order-invariant."""
    out1 = {ov.id for ov in n1.outvals}
    in1 = {iv.id for iv in n1.invals}
    in2 = {iv.id for iv in n2.invals}
    if out1 & in2:            # n2 consumes n1's output: dependency
        return False
    if in1 & in2:             # shared operand: last-consumer flips on swap
        return False
    return True


def exchange_pass(g: Graph, order: List[Node], envs: Sequence[Dict[str, int]],
                  *, max_sweeps: int = 4, decisions=None) -> List[Node]:
    """Bubble adjacent independent pairs while the local peak improves at
    every probe env.  Returns a (possibly) improved valid order.

    ``decisions`` (an ``obs.DecisionLog``) records each accepted swap with
    its local-peak justification at the first probe env."""
    order = list(order)
    n = len(order)
    # concrete byte sizes are order-invariant: evaluate once per probe env,
    # not once per sweep
    nbytes_per_env = [{v.id: v.nbytes_expr.evaluate(env) for v in g.values}
                      for env in envs]
    for _ in range(max_sweeps):
        effects = [_node_effects(g, order, env, nbytes)
                   for env, nbytes in zip(envs, nbytes_per_env)]
        swapped = False
        i = 0
        while i < n - 1:
            n1, n2 = order[i], order[i + 1]
            if _independent(n1, n2):
                better_all = True
                strictly = False
                for alloc, freed in effects:
                    a1, f1 = alloc[i], freed[i]
                    a2, f2 = alloc[i + 1], freed[i + 1]
                    cur = max(a1, a1 - f1 + a2)
                    swp = max(a2, a2 - f2 + a1)
                    if swp > cur:
                        better_all = False
                        break
                    if swp < cur:
                        strictly = True
                if better_all and strictly:
                    if decisions is not None:
                        a1, f1 = effects[0][0][i], effects[0][1][i]
                        a2, f2 = effects[0][0][i + 1], effects[0][1][i + 1]
                        decisions.add(
                            "exchange-swap",
                            f"{n1.prim_name}#{n1.id} <-> {n2.prim_name}#{n2.id}",
                            "swap",
                            "local peak lower at every probe env",
                            position=i,
                            peak_before=max(a1, a1 - f1 + a2),
                            peak_after=max(a2, a2 - f2 + a1))
                    order[i], order[i + 1] = n2, n1
                    for alloc, freed in effects:
                        alloc[i], alloc[i + 1] = alloc[i + 1], alloc[i]
                        freed[i], freed[i + 1] = freed[i + 1], freed[i]
                    swapped = True
                    i = max(i - 1, 0)  # bubble further left
                    continue
            i += 1
        if not swapped:
            break
    g.validate_order(order)
    return order
