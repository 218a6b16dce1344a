"""Execution-plan assembly (paper §2.3 compile-time half).

Combines the scheduled order with the memory plan into an
``ExecutionPlan``.  The rematerialization search and its candidates come
with ``memory_limit`` in a later part of the port; until then
``build_plan`` refuses ``enable_remat``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional

from ..ir.graph import Graph, Node
from ..scheduling.scheduler import ScheduleResult
from ..symbolic import ShapeGraph

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..memplan.assign import ArenaPlan


@dataclass
class ExecutionPlan:
    graph: Graph
    order: List[Node]
    shape_graph: ShapeGraph
    # value id -> sorted consumer positions
    use_positions: Dict[int, List[int]] = field(default_factory=dict)
    # compile-time buffer-reuse plan (None with memory_plan="none")
    arena_plan: Optional["ArenaPlan"] = None

    def __post_init__(self):
        pos = {n.id: i for i, n in enumerate(self.order)}
        for v in self.graph.values:
            self.use_positions[v.id] = sorted(
                pos[c.id] for c in v.consumers if c.id in pos)


def build_plan(graph: Graph, schedule: ScheduleResult,
               shape_graph: Optional[ShapeGraph] = None,
               *, enable_remat: bool = False,
               arena_plan: Optional["ArenaPlan"] = None) -> ExecutionPlan:
    if enable_remat:
        raise NotImplementedError(
            "the rematerialization search is not ported yet; it arrives "
            "together with memory_limit")
    sg = shape_graph if shape_graph is not None else ShapeGraph()
    return ExecutionPlan(graph=graph, order=list(schedule.order),
                         shape_graph=sg, arena_plan=arena_plan)
