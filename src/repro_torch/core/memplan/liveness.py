"""Liveness analysis over a scheduled order (memory-planner stage 1).

Produces one :class:`LiveInterval` per planned value: the step range during
which its buffer must exist, plus its symbolic byte count.  The discipline
mirrors ``scheduling/memsim.py`` and the interpreter exactly:

* an intermediate materializes when its producer executes and dies right
  after its last consumer (graph outputs survive the whole run);
* inputs/consts are caller-provided and live from before step 0; without
  donation they survive the run, with ``donate_inputs`` they die at their
  last consumer like any intermediate;
* a no-consumer non-output value is transient (the interpreter never
  stores it) and gets no interval.

Within one step, a node's outputs allocate *before* its dead inputs free,
so two intervals may share a buffer only when one ends strictly before the
other starts (``end < start``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

from ..ir.graph import Graph, Node
from ..symbolic import SymbolicExpr


@dataclass(frozen=True)
class LiveInterval:
    """Closed step range ``[start, end]`` during which a buffer must exist."""

    vid: int
    start: int            # -1 = caller-provided, exists before step 0
    end: int              # len(order) = survives the run (output / kept input)
    nbytes_expr: SymbolicExpr
    kind: str             # 'input' | 'const' | 'intermediate'
    is_output: bool

    @property
    def external(self) -> bool:
        """Caller-provided buffer (input/const) — not arena-allocated."""
        return self.kind in ("input", "const")

    def overlaps(self, other: "LiveInterval") -> bool:
        return not (self.end < other.start or other.end < self.start)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"LiveInterval(%{self.vid} [{self.start}, {self.end}] "
                f"{self.kind}{' out' if self.is_output else ''})")


def analyze_liveness(graph: Graph, order: Sequence[Node], *,
                     donate_inputs: bool = False) -> Dict[int, LiveInterval]:
    """Symbolic live intervals of every planned value under ``order``."""
    pos = {n.id: i for i, n in enumerate(order)}
    horizon = len(order)
    output_ids = {v.id for v in graph.outputs}
    out: Dict[int, LiveInterval] = {}

    def last_use(v) -> int:
        uses = [pos[c.id] for c in v.consumers if c.id in pos]
        return max(uses) if uses else -1

    for v in list(graph.inputs) + list(graph.consts):
        end = horizon
        if donate_inputs and v.id not in output_ids:
            lu = last_use(v)
            # the interpreter only frees at a consumer boundary; an unused
            # donated input is never visited, so it survives the run
            if lu >= 0:
                end = lu
        out[v.id] = LiveInterval(v.id, -1, end, v.nbytes_expr, v.kind,
                                 v.id in output_ids)

    for v in graph.values:
        if v.is_materialized_input() or v.producer is None:
            continue
        if v.producer.id not in pos:
            continue
        if not v.consumers and v.id not in output_ids:
            continue  # transient: the interpreter never stores it
        start = pos[v.producer.id]
        end = horizon if v.id in output_ids else max(last_use(v), start)
        out[v.id] = LiveInterval(v.id, start, end, v.nbytes_expr,
                                 "intermediate", v.id in output_ids)
    return out
