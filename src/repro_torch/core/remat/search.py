"""Compile-time recomputation-subgraph search (paper §2.3).

Port of ``repro/core/remat/search.py``.  For each rematerialization
candidate tensor, grow a recompute subgraph backwards from its producer,
evaluating the *symbolic* memory impact of each candidate subgraph:

    impact(S) = bytes(target) − Σ bytes(sources of S that are not always-live)

Graph inputs and constants are always live, so they contribute no cost.
The best subgraph seen is kept; a candidate is *recomputable* iff its best
impact is definitely positive under the shape graph.  Reload (offload)
plans are always available and memory-neutral.

Views carry 0 bytes (``ir.graph``), so a view is never a candidate: the
candidates are the storage roots, and a consumer of a view lists the
view's root among its inputs, so a recompute subgraph that reads a view
also keeps its root as a source.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Set, Tuple

from ..ir.graph import Graph, Node, Value
from ..ir.loop import is_loop_node
from ..symbolic import Cmp, Interval, ShapeGraph, SymbolicExpr, ZERO

# Relative cost model shared by compile-time pruning (here) and runtime victim
# scoring (remat/runtime.py): recompute cost ~ flops * RECOMPUTE_COST_PER_FLOP,
# offload+reload cost ~ bytes * (D2H + H2D).  Only the ratios matter.
RECOMPUTE_COST_PER_FLOP = 1.0 / 50.0   # flops are cheap relative to transfers
RELOAD_COST_PER_BYTE = 1.0             # H2D per byte
OFFLOAD_COST_PER_BYTE = 1.0            # D2H per byte (paid at eviction)

# the aten matmul family: the operand whose last dim is contracted
_MATMUL_LHS = {"aten.mm.default": 0, "aten.bmm.default": 0,
               "aten.matmul.default": 0, "aten.addmm.default": 1}


def node_flops(n: Node) -> SymbolicExpr:
    """Symbolic FLOPs of one node: 2·out·contraction for a matmul, one per
    output element for anything else.

    A node's ``params["contracting_dims"] = (operand index, dims)`` names
    the contracted dims of a product explicitly; the aten matmul family
    contracts the last dim of its left operand."""
    contract = n.params.get("contracting_dims")
    if contract is None and n.prim_name in _MATMUL_LHS:
        i = _MATMUL_LHS[n.prim_name]
        contract = (i, (len(n.invals[i].dims) - 1,))
    if contract is not None:
        i, dims = contract
        k = ZERO + 1
        for d in dims:
            k = k * n.invals[i].dims[d]
        return 2 * n.outvals[0].size_expr * k
    total = ZERO
    for ov in n.outvals:
        total = total + ov.size_expr
    return total


@dataclass
class RecomputePlan:
    target: Value
    node_ids: Tuple[int, ...]            # topo-ordered subgraph (graph node ids)
    source_ids: Tuple[int, ...]          # value ids that must be materialized
    impact: SymbolicExpr                 # symbolic memory benefit of evicting
    flops: SymbolicExpr                  # symbolic recompute cost
    # guaranteed ranges over the shape graph's declared dim bounds, computed
    # once at search time so the runtime policy never re-derives them
    impact_interval: Interval = Interval()
    flops_interval: Interval = Interval()


@dataclass
class CandidateInfo:
    value: Value
    recompute: Optional[RecomputePlan]   # None if no beneficial subgraph found
    bytes_interval: Interval = Interval()  # guaranteed range of device bytes
    # True when a beneficial recompute plan existed but interval bounds
    # proved reload always cheaper, so it was dropped at compile time
    recompute_pruned_by_bounds: bool = False


def static_regen_method(cand: CandidateInfo) -> Optional[str]:
    """Decide recompute-vs-offload at compile time when bounds prove it.

    Returns ``'recompute'`` / ``'offload'`` when one regeneration method is
    cheaper for *every* env within the declared dim ranges, else ``None``
    (the runtime policy evaluates concretely).  Candidates without a
    recompute plan are always ``'offload'``.
    """
    if cand.recompute is None:
        return "offload"
    flops = cand.recompute.flops_interval
    nbytes = cand.bytes_interval
    per_byte = RELOAD_COST_PER_BYTE + OFFLOAD_COST_PER_BYTE
    if flops.hi is not None and nbytes.lo is not None and \
            flops.hi * RECOMPUTE_COST_PER_FLOP <= nbytes.lo * per_byte:
        return "recompute"
    if nbytes.hi is not None and flops.lo is not None and \
            flops.lo * RECOMPUTE_COST_PER_FLOP >= nbytes.hi * per_byte:
        return "offload"
    return None


class RecomputeSearcher:
    """``expr_cache`` (optional, shareable) memoizes the *expressions* the
    search builds — subgraph impacts, source lists, per-node flops — keyed
    on graph structure only.  They are range-independent, so one cache can
    serve several searches over the same graph under different ranges."""

    def __init__(self, graph: Graph, shape_graph: Optional[ShapeGraph] = None,
                 *, max_subgraph: int = 24,
                 expr_cache: Optional[Dict] = None):
        self.g = graph
        self.sg = shape_graph if shape_graph is not None else ShapeGraph()
        self.max_subgraph = max_subgraph
        self._output_ids = {v.id for v in graph.outputs}
        self._cache: Dict = expr_cache if expr_cache is not None else {}
        # pick-the-biggest-source results, keyed by the tuple of candidate
        # *size-expression* uids.  Transformer layers repeat the same size
        # tuples hundreds of times; the argmax depends only on the sizes and
        # this graph's verdicts, so it is shared per searcher (per compile).
        # Each entry stores the compare keys its argmax consulted: a memo
        # hit replays them into any active dependency recording
        self._pick_memo: Dict[Tuple[int, ...], Tuple[int, frozenset]] = {}

    def _node_flops(self, n: Node) -> SymbolicExpr:
        key = ("nflops", n.id)
        hit = self._cache.get(key)
        if hit is None:
            hit = node_flops(n)
            self._cache[key] = hit
        return hit

    def search(self, target: Value,
               bytes_interval: Optional[Interval] = None
               ) -> Optional[RecomputePlan]:
        """Greedy backward growth, keeping the best symbolic impact seen.

        The subgraph's impact expression and source set are maintained
        *incrementally* as nodes are absorbed — absorbing ``p`` removes the
        sources ``p`` produces (their bytes return to the impact) and adds
        ``p``'s own unproduced inputs — and each grown state is memoized in
        ``expr_cache`` keyed on ``(target, subgraph)``.
        """
        if target.producer is None or is_loop_node(target.producer):
            # rolled loops are remat barriers: re-running a trip-count-many
            # iteration body is never the cheap side of the trade, and remat
            # decisions are hoisted out of the body by construction
            return None
        # bounds-based compile-time prune: a target whose worst-case byte
        # count is zero can never free memory, skip the subgraph search
        if bytes_interval is None:
            bytes_interval = self.sg.interval_of(target.nbytes_expr)
        if bytes_interval.hi == 0:
            return None
        p0 = target.producer
        sub_ids = frozenset((p0.id,))
        sub_nodes: Set[Node] = {p0}
        produced = {ov.id for ov in p0.outvals}
        key = (target.id, sub_ids)
        hit = self._cache.get(key)
        if hit is not None:
            imp, srcs_t, flops = hit
            srcs = {v.id: v for v in srcs_t}
        else:
            srcs = {}
            imp = target.nbytes_expr
            for iv in p0.invals:
                if iv.id in produced or iv.id in srcs:
                    continue
                srcs[iv.id] = iv
                if not iv.is_materialized_input():
                    imp = imp - iv.nbytes_expr
            flops = self._node_flops(p0)
            self._cache[key] = (imp, tuple(srcs.values()), flops)
        best = (imp, sub_ids, set(sub_nodes), flops)
        while len(sub_ids) < self.max_subgraph:
            # pick the most expensive non-always-live source to absorb
            cand = [s for s in srcs.values()
                    if not s.is_materialized_input() and s.producer is not None
                    and not is_loop_node(s.producer)]    # loops don't absorb
            if not cand:
                break
            sizes = tuple(s.nbytes_expr.uid for s in cand)
            hit = self._pick_memo.get(sizes)
            if hit is not None:
                idx, pick_keys = hit
                self.sg.note_cmp_keys(pick_keys)
            else:
                with self.sg.record_cmp_keys() as pick_keys:
                    idx = 0
                    for j in range(1, len(cand)):
                        if self.sg.compare(cand[j].nbytes_expr,
                                           cand[idx].nbytes_expr) is Cmp.GT:
                            idx = j
                self._pick_memo[sizes] = (idx, frozenset(pick_keys))
            p = cand[idx].producer
            if p.id in sub_ids:
                break
            sub_ids = sub_ids | {p.id}
            sub_nodes.add(p)
            key = (target.id, sub_ids)
            hit = self._cache.get(key)
            if hit is not None:
                imp, srcs_t, flops = hit
                srcs = {v.id: v for v in srcs_t}
                for ov in p.outvals:
                    produced.add(ov.id)
            else:
                for ov in p.outvals:
                    produced.add(ov.id)
                    s = srcs.pop(ov.id, None)
                    if s is not None and not s.is_materialized_input():
                        imp = imp + s.nbytes_expr   # no longer a source
                for iv in p.invals:
                    if iv.id in produced or iv.id in srcs:
                        continue
                    srcs[iv.id] = iv
                    if not iv.is_materialized_input():
                        imp = imp - iv.nbytes_expr
                flops = flops + self._node_flops(p)
                self._cache[key] = (imp, tuple(srcs.values()), flops)
            if self.sg.compare(imp, best[0]) is Cmp.GT:
                best = (imp, sub_ids, set(sub_nodes), flops)
        best_imp, best_ids, best_nodes, best_flops = best
        # beneficial iff impact definitely > 0
        if self.sg.compare(best_imp, ZERO) is not Cmp.GT:
            return None
        order = [n for n in self.g.nodes if n in best_nodes]  # topo by construction
        node_ids = tuple(n.id for n in order)
        sources = tuple(s.id for s in self._cache[(target.id, best_ids)][1])
        return RecomputePlan(target, node_ids, sources,
                             best_imp, best_flops,
                             impact_interval=self.sg.interval_of(best_imp),
                             flops_interval=self.sg.interval_of(best_flops))

    # -- full exploration (paper: "explores all rematerialization candidates") --
    def explore(self, order: Sequence[Node], *,
                cand_keys_out: Optional[Dict[int, frozenset]] = None,
                parent_sg: Optional[ShapeGraph] = None,
                parent_cands: Optional[Dict[int, CandidateInfo]] = None,
                parent_cand_keys: Optional[Dict[int, frozenset]] = None,
                ) -> Dict[int, CandidateInfo]:
        """Search regeneration plans for every remat candidate.

        Candidates are intermediate values with at least one consumer that is
        not their producer's immediate successor (i.e. they stay live across
        other ops), that are not graph outputs, and that can hold bytes
        (which rules out views).

        ``cand_keys_out`` (a dict to fill) records, per candidate, the
        compare keys its search consulted.  With ``parent_*`` set, the
        exploration is **incremental**: a candidate whose parent search
        consulted only verdicts that are unchanged under this (narrowed)
        graph would retrace the identical growth path, so its parent result
        is reused with intervals refreshed and the bounds prunes re-applied
        (:func:`respecialize_candidates` logic) — only candidates an
        actually-flipped verdict touches are re-searched.
        """
        pos = {n.id: i for i, n in enumerate(order)}
        out: Dict[int, CandidateInfo] = {}
        for v in self.g.values:
            if v.kind != "intermediate" or v.id in self._output_ids:
                continue
            if v.producer is None or not v.consumers:
                continue
            p = pos.get(v.producer.id)
            if p is None:
                continue
            if is_loop_node(v.producer):
                continue  # loop outputs are remat barriers
            if self.g.bound_dims and \
                    v.nbytes_expr.free_vars() & set(self.g.bound_dims):
                # bound-dependent values are remat barriers too: their
                # tight size exists only in the live call env, and
                # re-running the introducing op re-measures — the planner
                # cannot price or replay that statically
                continue
            last_use = max(pos[c.id] for c in v.consumers if c.id in pos)
            if last_use <= p + 1:
                continue  # never idle: evicting it can't help
            bytes_iv = self.sg.interval_of(v.nbytes_expr)
            if bytes_iv.hi == 0:
                continue  # provably empty for every env: never profitable
            if parent_cands is not None and v.id in parent_cands:
                pk = (parent_cand_keys or {}).get(v.id)
                if pk is not None and self.sg.verdicts_match(parent_sg, pk):
                    out[v.id] = _respecialize_one(parent_cands[v.id],
                                                  self.sg, bytes_iv)
                    if cand_keys_out is not None:
                        cand_keys_out[v.id] = pk
                    continue
            if cand_keys_out is not None:
                with self.sg.record_cmp_keys() as keys:
                    rp = self.search(v, bytes_iv)
                cand_keys_out[v.id] = frozenset(keys)
            else:
                rp = self.search(v, bytes_iv)
            info = CandidateInfo(value=v, recompute=rp,
                                 bytes_interval=bytes_iv)
            if info.recompute is not None and \
                    static_regen_method(info) == "offload":
                # bounds prove reload is cheaper for every env in range:
                # drop the recompute plan at compile time so the runtime
                # never scores it
                info = CandidateInfo(value=v, recompute=None,
                                     bytes_interval=bytes_iv,
                                     recompute_pruned_by_bounds=True)
            out[v.id] = info
        return out


def _respecialize_one(info: CandidateInfo, sg: ShapeGraph,
                      bytes_iv: Interval) -> CandidateInfo:
    """One candidate's intervals refreshed + bounds prunes re-applied under
    a narrowed graph (see :func:`respecialize_candidates`)."""
    from dataclasses import replace

    rp = info.recompute
    if rp is not None:
        rp = replace(rp,
                     impact_interval=sg.interval_of(rp.impact),
                     flops_interval=sg.interval_of(rp.flops))
    new = CandidateInfo(value=info.value, recompute=rp,
                        bytes_interval=bytes_iv,
                        recompute_pruned_by_bounds=
                        info.recompute_pruned_by_bounds)
    if new.recompute is not None and static_regen_method(new) == "offload":
        new = CandidateInfo(value=info.value, recompute=None,
                            bytes_interval=bytes_iv,
                            recompute_pruned_by_bounds=True)
    return new


def respecialize_candidates(candidates: Dict[int, CandidateInfo],
                            sg: ShapeGraph) -> Dict[int, CandidateInfo]:
    """Re-derive a candidate set's interval data under a narrowed graph.

    The *structure* of the search result — which subgraph regenerates each
    candidate — depends only on ``ShapeGraph.compare`` verdicts; when the
    incremental compile path has proven those unchanged under a bucket's
    narrowed ranges, re-running :meth:`RecomputeSearcher.explore` would
    reproduce the same subgraphs.  This reproduces its *output* instead:
    refresh every stored interval under the narrowed bounds (tighter
    buckets pin more regen decisions statically) and re-apply the two
    bounds-based prunes, both of which are monotone under narrowing —
    ``bytes_interval.hi == 0`` only becomes true as ranges shrink, and a
    parent-pruned recompute plan (reload provably cheaper everywhere) stays
    pruned on every sub-range.
    """
    out: Dict[int, CandidateInfo] = {}
    for vid, info in candidates.items():
        bytes_iv = sg.interval_of(info.value.nbytes_expr)
        if bytes_iv.hi == 0:
            continue          # explore() would have skipped it outright
        out[vid] = _respecialize_one(info, sg, bytes_iv)
    return out
