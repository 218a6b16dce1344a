"""Peak-memory simulation of a schedule: exact (concrete env) and bounded.

``simulate_peak`` replays a schedule under a concrete dim binding and
reports exact peak bytes — used to *verify* that the symbolic scheduling
decisions actually reduce peak memory (the paper validates against
precise-shape optimization results), and by benchmarks to report peak bytes
without executing anything.

``simulate_peak_bound`` replays the same liveness discipline *symbolically*:
the live set's byte count stays a ``SymbolicExpr``, and each step is bounded
with interval arithmetic over the shape graph's declared dim ranges.  The
returned ``hi`` is a **guaranteed worst-case peak** — for every env within
the declared ranges, ``simulate_peak(...).peak_bytes <= hi`` — which is what
lets a bounded-dynamic-shape deployment size its arena at compile time.
When a ``shape_graph`` is passed to ``simulate_peak`` the bound is attached
to the timeline as ``peak_bound_bytes`` / ``peak_bound_lo``.

Rolled loops are not part of this package yet: every node is a plain op.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..ir.graph import Graph, Node
from ..symbolic import ShapeGraph, SymbolicExpr, ZERO


@dataclass
class MemTimeline:
    peak_bytes: int
    steps: List[int] = field(default_factory=list)  # usage after each node
    base_bytes: int = 0  # inputs + consts held for the whole run
    # guaranteed bounds on peak over all envs within declared dim ranges
    # (None when no shape graph was supplied or a dim is unbounded above)
    peak_bound_bytes: Optional[int] = None
    peak_bound_lo: Optional[int] = None

    def __repr__(self) -> str:  # pragma: no cover
        bound = "" if self.peak_bound_bytes is None else \
            f", bound<={self.peak_bound_bytes}"
        return (f"MemTimeline(peak={self.peak_bytes}, base={self.base_bytes}, "
                f"n={len(self.steps)}{bound})")


def simulate_peak(graph: Graph, order: Sequence[Node], env: Dict[str, int],
                  *, count_inputs: bool = True,
                  donate_inputs: bool = False,
                  shape_graph: Optional[ShapeGraph] = None) -> MemTimeline:
    """Simulate exact memory usage of executing ``order``.

    - outputs of a node allocate at execution;
    - a value frees right after its last consumer executes (unless it is a
      graph output, which stays live to the end);
    - inputs/consts are live from the start; with ``donate_inputs`` they free
      after their last use (buffer donation).

    With ``shape_graph`` given, additionally computes the guaranteed
    worst-case peak bound over its declared dim ranges (see
    :func:`simulate_peak_bound`).
    """
    nbytes: Dict[int, int] = {}
    for v in graph.values:
        nbytes[v.id] = v.nbytes_expr.evaluate(env)

    output_ids = {v.id for v in graph.outputs}
    remaining: Dict[int, int] = {}
    pos = {n.id: i for i, n in enumerate(order)}
    for v in graph.values:
        remaining[v.id] = sum(1 for c in v.consumers if c.id in pos)

    usage = 0
    base = 0
    if count_inputs:
        for v in list(graph.inputs) + list(graph.consts):
            usage += nbytes[v.id]
            base += nbytes[v.id]

    peak = usage
    steps: List[int] = []
    live_intermediate: Dict[int, int] = {}

    for n in order:
        # allocate outputs (dead outputs are transient: alloc + free same step)
        transient = 0
        for ov in n.outvals:
            b = nbytes[ov.id]
            if ov.consumers or ov.id in output_ids:
                usage += b
                live_intermediate[ov.id] = b
            else:
                transient += b
        peak = max(peak, usage + transient)
        # free inputs whose last consumer just ran
        seen = set()
        for iv in n.invals:
            if iv.id in seen:
                continue
            seen.add(iv.id)
            remaining[iv.id] -= sum(1 for x in n.invals if x.id == iv.id)
            if remaining[iv.id] == 0 and iv.id not in output_ids:
                if iv.is_materialized_input():
                    if donate_inputs:
                        usage -= nbytes[iv.id]
                else:
                    if iv.id in live_intermediate:
                        usage -= live_intermediate.pop(iv.id)
        steps.append(usage)

    tl = MemTimeline(peak_bytes=peak, steps=steps, base_bytes=base)
    if shape_graph is not None:
        tl.peak_bound_lo, tl.peak_bound_bytes = simulate_peak_bound(
            graph, order, shape_graph,
            count_inputs=count_inputs, donate_inputs=donate_inputs)
    return tl


def simulate_peak_bound(graph: Graph, order: Sequence[Node],
                        shape_graph: ShapeGraph,
                        *, count_inputs: bool = True,
                        donate_inputs: bool = False,
                        ) -> Tuple[Optional[int], Optional[int]]:
    """Guaranteed ``(lo, hi)`` bounds on the peak of executing ``order``.

    Mirrors :func:`simulate_peak`'s liveness discipline with a symbolic
    running-usage expression, bounding each step with interval arithmetic
    over ``shape_graph``'s declared dim ranges.  Sound both ways: for every
    env within the ranges, ``lo <= simulate_peak(...).peak_bytes <= hi``
    (``hi`` is ``None`` when some live dim has no declared upper bound).
    """
    output_ids = {v.id for v in graph.outputs}
    pos = {n.id: i for i, n in enumerate(order)}
    remaining = {v.id: sum(1 for c in v.consumers if c.id in pos)
                 for v in graph.values}
    bounds_env = shape_graph.bound_env()
    # canonicalize each value's byte expression once through the equalities
    nbytes_expr = {v.id: shape_graph.canonicalize(v.nbytes_expr)
                   for v in graph.values}

    usage = ZERO
    if count_inputs:
        for v in list(graph.inputs) + list(graph.consts):
            usage = usage + nbytes_expr[v.id]

    iv0 = usage.interval(bounds_env)
    peak_lo, peak_hi = iv0.lo, iv0.hi
    live: Dict[int, SymbolicExpr] = {}

    for n in order:
        transient = ZERO
        for ov in n.outvals:
            e = nbytes_expr[ov.id]
            if ov.consumers or ov.id in output_ids:
                usage = usage + e
                live[ov.id] = e
            else:
                transient = transient + e
        iv_step = (usage + transient).interval(bounds_env)
        # peak = max over steps, bounded per side (None = unbounded above;
        # a None step lower bound cannot happen for sums of dims >= 0)
        if iv_step.lo is not None and (peak_lo is None or iv_step.lo > peak_lo):
            peak_lo = iv_step.lo
        if peak_hi is not None:
            peak_hi = None if iv_step.hi is None else max(peak_hi, iv_step.hi)
        seen = set()
        for ivv in n.invals:
            if ivv.id in seen:
                continue
            seen.add(ivv.id)
            remaining[ivv.id] -= sum(1 for x in n.invals if x.id == ivv.id)
            if remaining[ivv.id] == 0 and ivv.id not in output_ids:
                if ivv.is_materialized_input():
                    if donate_inputs:
                        usage = usage - nbytes_expr[ivv.id]
                else:
                    if ivv.id in live:
                        usage = usage - live.pop(ivv.id)

    return peak_lo, peak_hi
