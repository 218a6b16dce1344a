"""Operation scheduling based on symbolic shapes (paper §2.2).

List scheduling: repeatedly pick from the ReadySet the op with the most
favourable *memory impact*, where

    impact(op) = Σ bytes(outputs) − Σ bytes(inputs this op frees)

expressed as a ``SymbolicExpr`` and compared through the symbolic shape
graph.  When two impacts are incomparable we fall back to the paper's
lifetime-based topology heuristic.

A node's impact depends only on the *remaining-use counts* of its inputs,
and scheduling one op changes those counts for just the ops sharing an
operand with it.  The main loop therefore caches each ready op's impact
expression and invalidates only the sharers when a pick lands —
incremental maintenance instead of the former every-step recomputation,
which made the loop O(steps × ready-set × op-arity).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..ir.graph import Graph, Node, Value
from ..symbolic import Cmp, ShapeGraph, SymbolicExpr, ZERO


@dataclass
class ScheduleResult:
    order: List[Node]
    # how many ReadySet decisions were resolved symbolically vs by tie-break
    symbolic_decisions: int
    tiebreak_decisions: int

    @property
    def decision_symbolic_fraction(self) -> float:
        total = self.symbolic_decisions + self.tiebreak_decisions
        return self.symbolic_decisions / total if total else 1.0


class OpScheduler:
    """Paper §2.2 ``OpScheduler`` main loop."""

    def __init__(self, graph: Graph, shape_graph: Optional[ShapeGraph] = None,
                 *, count_input_frees: bool = False,
                 incremental_impact: bool = True,
                 impact_expr_cache: Optional[Dict] = None):
        self.g = graph
        self.sg = shape_graph if shape_graph is not None else ShapeGraph()
        self.count_input_frees = count_input_frees
        # False recomputes every ready impact each step (the pre-cache
        # behaviour) — kept for differential testing and benchmarking
        self.incremental_impact = incremental_impact
        self._cmp_cache: Dict[Tuple[SymbolicExpr, SymbolicExpr], Cmp] = {}
        self._output_ids = {v.id for v in graph.outputs}
        # (node id, frozenset of freed value ids) -> impact expr.  The
        # expression is pure graph structure, so bucketed specialization
        # shares one cache across every per-bucket schedule: re-runs
        # re-decide verdicts under their narrowed ranges but never rebuild
        # an impact polynomial
        self._expr_cache: Dict = impact_expr_cache \
            if impact_expr_cache is not None else {}
        # node id -> deduped [(input value, multiplicity)]: _impact and the
        # tiebreak both need "is n the last remaining consumer of iv", and
        # recounting multiplicities per query made them quadratic in arity
        self._in_mult: Dict[int, list] = {}
        for n in graph.nodes:
            seen: Dict[int, list] = {}
            for iv in n.invals:
                e = seen.get(iv.id)
                if e is None:
                    seen[iv.id] = [iv, 1]
                else:
                    e[1] += 1
            self._in_mult[n.id] = [(iv, m) for iv, m in seen.values()]

    # -- symbolic comparison with memoization ---------------------------------
    def _compare(self, a: SymbolicExpr, b: SymbolicExpr) -> Cmp:
        key = (a, b)
        hit = self._cmp_cache.get(key)
        if hit is None:
            hit = self.sg.compare(a, b)
            self._cmp_cache[key] = hit
        return hit

    # -- memory impact ----------------------------------------------------------
    def _impact(self, n: Node, remaining: Dict[int, int]) -> SymbolicExpr:
        # the cheap half: which inputs would scheduling n free right now?
        # (n frees iv when it is iv's only remaining consumer — multiplicity
        # counted, n may consume iv several times)
        freed: Dict[int, Value] = {}
        for iv, mult in self._in_mult[n.id]:
            if not self.count_input_frees and iv.is_materialized_input():
                continue
            if iv.id in self._output_ids:
                continue
            if remaining[iv.id] == mult:
                freed[iv.id] = iv
        # the expensive half — assembling the polynomial — is memoized on
        # (node, freed set); identical across schedules and shape graphs
        key = (n.id, frozenset(freed))
        imp = self._expr_cache.get(key)
        if imp is None:
            imp = ZERO
            for ov in n.outvals:
                if ov.consumers or ov.id in self._output_ids:
                    imp = imp + ov.nbytes_expr
            for iv in freed.values():
                imp = imp - iv.nbytes_expr
            self._expr_cache[key] = imp
        return imp

    # -- tie-break: smaller overall tensor lifetimes (paper fallback) ----------
    def _tiebreak_key(self, n: Node, orig_pos: Dict[int, int],
                      remaining: Dict[int, int]) -> Tuple:
        frees = 0
        for iv, mult in self._in_mult[n.id]:
            if remaining.get(iv.id, 0) == mult and not iv.is_materialized_input():
                frees += 1
        # prefer ops that free tensors, then ops whose results are consumed
        # soon (small distance to first consumer in original order), then
        # original program order for stability.
        next_use = min(
            (orig_pos[c.id] for ov in n.outvals for c in ov.consumers),
            default=orig_pos[n.id],
        )
        return (-frees, next_use, orig_pos[n.id])

    # -- main loop ----------------------------------------------------------------
    def schedule(self) -> ScheduleResult:
        g = self.g
        orig_pos = {n.id: i for i, n in enumerate(g.nodes)}
        # dependency counts
        deps: Dict[int, int] = {}
        for n in g.nodes:
            cnt = 0
            seen = set()
            for iv in n.invals:
                p = iv.producer
                if p is not None and p.id not in seen:
                    seen.add(p.id)
                    cnt += 1
            deps[n.id] = cnt
        remaining: Dict[int, int] = {}
        for v in g.values:
            remaining[v.id] = len(v.consumers)
        ready: List[Node] = sorted(
            (n for n in g.nodes if deps[n.id] == 0), key=lambda n: orig_pos[n.id])
        order: List[Node] = []
        sym_dec = tie_dec = 0
        node_by_id = {n.id: n for n in g.nodes}
        # children map: node -> nodes depending on it
        children: Dict[int, List[Node]] = {n.id: [] for n in g.nodes}
        for n in g.nodes:
            seen = set()
            for iv in n.invals:
                p = iv.producer
                if p is not None and p.id not in seen:
                    seen.add(p.id)
                    children[p.id].append(n)

        # consumers-by-value: whose impact a remaining-count change touches
        consumers_of = {}
        for n in g.nodes:
            for iv in n.invals:
                consumers_of.setdefault(iv.id, []).append(n)
        # node id -> cached impact expr, dropped when an operand's remaining
        # count changes (only then can the freed-set, hence impact, change)
        impact_cache: Dict[int, SymbolicExpr] = {}

        def impact_of(n: Node) -> SymbolicExpr:
            if not self.incremental_impact:
                return self._impact(n, remaining)
            imp = impact_cache.get(n.id)
            if imp is None:
                imp = self._impact(n, remaining)
                impact_cache[n.id] = imp
            return imp

        tb_memo: Dict[int, Tuple] = {}   # per-step tiebreak keys

        def tb_key(n: Node) -> Tuple:
            k = tb_memo.get(n.id)
            if k is None:
                k = self._tiebreak_key(n, orig_pos, remaining)
                tb_memo[n.id] = k
            return k

        while ready:
            # pick best by symbolic impact, tie-break by lifetime heuristic
            best = ready[0]
            best_imp = impact_of(best)
            for i in range(1, len(ready)):
                cand = ready[i]
                ci = impact_of(cand)
                c = self._compare(ci, best_imp)
                if c in (Cmp.LT, Cmp.LE):
                    # cand's impact is no worse everywhere (strictly better
                    # for LT); switching is symbolically justified — with
                    # declared dim ranges the interval fallback turns many
                    # previously UNKNOWN pairs into LT/LE/GE/GT here.
                    best, best_imp = cand, ci
                    sym_dec += 1
                elif c in (Cmp.GT, Cmp.GE):
                    # keeping the incumbent is symbolically justified
                    sym_dec += 1
                else:  # EQ (memory-neutral) / UNKNOWN -> lifetime tie-break
                    tie_dec += 1
                    if tb_key(cand) < tb_key(best):
                        best, best_imp = cand, ci
            ready.remove(best)
            order.append(best)
            impact_cache.pop(best.id, None)
            tb_memo.clear()
            # update refcounts; any op sharing a decremented operand may now
            # free it (or no longer), so its cached impact is stale
            for iv in best.invals:
                remaining[iv.id] -= 1
            for iv in {iv.id: iv for iv in best.invals}.values():
                for sharer in consumers_of.get(iv.id, ()):
                    impact_cache.pop(sharer.id, None)
            for ov in best.outvals:
                remaining[ov.id] = len(ov.consumers)
            # new ready nodes enter in original-program-order position
            # (insort keeps the list sorted; no full re-sort per step)
            for ch in children[best.id]:
                deps[ch.id] -= 1
                if deps[ch.id] == 0:
                    bisect.insort(ready, ch, key=lambda n: orig_pos[n.id])

        g.validate_order(order)
        return ScheduleResult(order, sym_dec, tie_dec)


def schedule_graph(graph: Graph, shape_graph: Optional[ShapeGraph] = None,
                   **kw) -> ScheduleResult:
    return OpScheduler(graph, shape_graph, **kw).schedule()
