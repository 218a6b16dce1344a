"""Execution-plan assembly (paper §2.3 compile-time half).

Combines the scheduled order with the regeneration-plan search results into
an ``ExecutionPlan``: conceptually the original graph with a
``Remat::EvictOp`` after every op (realised as the executors' evict check
at op boundaries) and ``Remat::RegenerateOp`` before every consumer of a
candidate tensor (realised as the executors' materialize-on-demand).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

from ..ir.graph import Graph, Node
from ..scheduling.scheduler import ScheduleResult
from ..symbolic import ShapeGraph
from .search import CandidateInfo, RecomputeSearcher, static_regen_method

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..memplan.assign import ArenaPlan


@dataclass
class ExecutionPlan:
    graph: Graph
    order: List[Node]
    shape_graph: ShapeGraph
    candidates: Dict[int, CandidateInfo] = field(default_factory=dict)
    node_by_id: Dict[int, Node] = field(default_factory=dict)
    # positions for next-use estimation at runtime
    pos: Dict[int, int] = field(default_factory=dict)
    # value id -> sorted consumer positions
    use_positions: Dict[int, List[int]] = field(default_factory=dict)
    # value id -> regen method fixed at compile time by interval bounds
    # ('recompute' | 'offload'); absent keys stay env-dependent at runtime
    static_methods: Dict[int, str] = field(default_factory=dict)
    # compile-time buffer-reuse plan (None with memory_plan="none")
    arena_plan: Optional["ArenaPlan"] = None
    # kernel-variant selection (node id -> param overrides / selection
    # record); baked into lowered Compute arguments, never into the shared
    # ``node.params`` — plans for other buckets see their own choices
    kernel_overrides: Dict[int, Dict[str, object]] = field(default_factory=dict)
    kernel_selections: Dict[int, object] = field(default_factory=dict)

    def __post_init__(self):
        self.node_by_id = {n.id: n for n in self.graph.nodes}
        self.pos = {n.id: i for i, n in enumerate(self.order)}
        for v in self.graph.values:
            self.use_positions[v.id] = sorted(
                self.pos[c.id] for c in v.consumers if c.id in self.pos)
        if not self.static_methods:
            for vid, cand in self.candidates.items():
                if cand.recompute_pruned_by_bounds:
                    # bounds dropped the recompute plan during the search
                    self.static_methods[vid] = "offload"
                elif cand.recompute is not None:
                    m = static_regen_method(cand)
                    if m is not None:
                        self.static_methods[vid] = m
                # recompute=None without the pruned flag means the search
                # simply found no beneficial subgraph — the bounds decided
                # nothing, so it is not a static decision

    @property
    def n_static_regen(self) -> int:
        """Candidates whose regen method the bounds fixed at compile time."""
        return len(self.static_methods)

    @property
    def n_candidates(self) -> int:
        return len(self.candidates)

    @property
    def n_recomputable(self) -> int:
        return sum(1 for c in self.candidates.values()
                   if c.recompute is not None)


def build_plan(graph: Graph, schedule: ScheduleResult,
               shape_graph: Optional[ShapeGraph] = None,
               *, enable_remat: bool = True,
               max_subgraph: int = 24,
               arena_plan: Optional["ArenaPlan"] = None,
               remat_expr_cache: Optional[Dict] = None,
               cand_keys_out: Optional[Dict[int, frozenset]] = None,
               parent_remat: Optional[Tuple] = None) -> ExecutionPlan:
    """``remat_expr_cache``: the searcher's shareable expression cache
    (see :class:`RecomputeSearcher`).  ``cand_keys_out``/``parent_remat``
    thread the incremental-compile protocol into the search: the former
    collects each candidate's compare keys, the latter — ``(parent shape
    graph, parent candidates, parent candidate keys)`` — lets
    :meth:`RecomputeSearcher.explore` reuse every parent candidate whose
    verdicts are unchanged under ``shape_graph``."""
    sg = shape_graph if shape_graph is not None else ShapeGraph()
    candidates: Dict[int, CandidateInfo] = {}
    if enable_remat:
        searcher = RecomputeSearcher(graph, sg, max_subgraph=max_subgraph,
                                     expr_cache=remat_expr_cache)
        p_sg = p_cands = p_keys = None
        if parent_remat is not None:
            p_sg, p_cands, p_keys = parent_remat
        candidates = searcher.explore(schedule.order,
                                      cand_keys_out=cand_keys_out,
                                      parent_sg=p_sg,
                                      parent_cands=p_cands,
                                      parent_cand_keys=p_keys)
    return ExecutionPlan(graph=graph, order=list(schedule.order),
                         shape_graph=sg, candidates=candidates,
                         arena_plan=arena_plan)
