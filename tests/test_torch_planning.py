"""The port's planning modules against the reference's, on the same IR.

A test-only bridge turns the reference's traced ``Graph`` of the smoke
train step of each bench arch (``benchmarks/memplan_bench.py``'s
``_step_and_specs``: ``llama2_1b``, ``gemma_2b``, ``granite_8b``,
``musicgen_medium``) into a port
``Graph`` with the same value and node ids, sizes and edges (bounded dims
and rolled loops included: ``test_torch_bounded`` and ``test_torch_loops``
bridge those graphs).  The copied
scheduler, simulators and memory planner must then decide identically:
scheduled order, ``symbolic_decisions``, exact peaks, the guaranteed peak
bound, the exchange post-pass, arena slots and ``arena_bound_bytes``.
"""
import numpy as np
import pytest
import torch

import repro.core.symbolic as R
import repro_torch.core.symbolic as P
from repro.core.memplan import build_arena_plan as r_arena
from repro.core.scheduling import schedule_graph as r_schedule
from repro.core.scheduling import simulate_peak as r_peak
from repro.core.scheduling import simulate_peak_bound as r_bound
from repro.core.scheduling.exchange import exchange_pass as r_exchange
from repro_torch.core.ir.graph import Graph
from repro_torch.core.memplan import build_arena_plan as p_arena
from repro_torch.core.scheduling import schedule_graph as p_schedule
from repro_torch.core.scheduling import simulate_peak as p_peak
from repro_torch.core.scheduling import simulate_peak_bound as p_bound
from repro_torch.core.scheduling.exchange import exchange_pass as p_exchange
from test_torch_bench_archs import BENCH_ARCHS

RANGES = {"b": (1, 64), "s": (16, 4096)}        # memplan_bench's ranges
ENVS = [{"b": 1, "s": 16}, {"b": 8, "s": 512}, {"b": 64, "s": 4096}]


def bridge(ref_graph) -> Graph:
    """Reference ``Graph`` -> port ``Graph`` (same ids, sizes and edges).

    Bounded dims (``bound_dims``, ``bound_intros``) and rolled loops (a
    ``LoopBody`` over the bridged body graph) come along.  Each node gets
    an argument template naming its inputs in order, so the port can lower
    (not run) the graph."""
    from repro.core.ir.loop import loop_body_of
    from repro.core.symbolic.expr import Atom as RAtom
    from repro_torch.core.ir.capture import Arg
    from repro_torch.core.ir.dynamism import BoundIntro
    from repro_torch.core.ir.loop import LOOP_PARAM, LoopBody
    from torch.utils import _pytree as pytree

    def atom(a):
        if isinstance(a, RAtom):
            return P.Atom(a.name)
        return P.OpAtom(a.op, tuple(expr(o) for o in a.operands))

    def expr(e):
        return P.SymbolicExpr({tuple((atom(a), x) for a, x in mono): c
                               for mono, c in e.terms})

    g = Graph()
    for v in ref_graph.values:
        pv = g.new_value([expr(d) for d in v.dims],
                         getattr(torch, np.dtype(v.dtype).name), kind=v.kind,
                         name=v.name)
        assert pv.id == v.id
    g.inputs = [g.values[v.id] for v in ref_graph.inputs]
    g.consts = [g.values[v.id] for v in ref_graph.consts]
    g.outputs = [g.values[v.id] for v in ref_graph.outputs]
    for n in ref_graph.nodes:
        body = loop_body_of(n)
        if body is not None:
            params = {LOOP_PARAM: LoopBody(
                graph=bridge(body.graph), num_consts=body.num_consts,
                num_carry=body.num_carry, num_xs=body.num_xs,
                length_expr=expr(body.length_expr)), "multi": True}
        else:
            leaves, spec = pytree.tree_flatten(
                (tuple(Arg(i) for i in range(len(n.invals))), {}))
            params = {"leaves": leaves, "spec": spec,
                      "multi": len(n.outvals) != 1}
        pn = g.add_node(None, [g.values[v.id] for v in n.invals],
                        [g.values[v.id] for v in n.outvals], params,
                        prim_name=n.prim_name)
        assert pn.id == n.id
    for name, cap in ref_graph.bound_dims.items():
        g.bound_dims[name] = expr(cap)
    for nid, bi in ref_graph.bound_intros.items():
        g.bound_intros[nid] = BoundIntro(
            name=bi.name, cap=expr(bi.cap), node_id=bi.node_id,
            padded_out=bi.padded_out, count_out=bi.count_out, axis=bi.axis)
    return g


@pytest.fixture(scope="module", params=BENCH_ARCHS)
def graphs(request):
    from benchmarks.memplan_bench import _step_and_specs
    from repro.core.ir import trace_to_graph
    step, args = _step_and_specs(request.param)
    ref_graph, _ = trace_to_graph(step, *args)
    return ref_graph, bridge(ref_graph)


@pytest.fixture(scope="module")
def planned(graphs):
    ref_graph, port_graph = graphs
    sg_r, sg_p = R.ShapeGraph(), P.ShapeGraph()
    R.declare_dim_ranges(sg_r, RANGES)
    P.declare_dim_ranges(sg_p, RANGES)
    return (r_schedule(ref_graph, sg_r), p_schedule(port_graph, sg_p),
            sg_r, sg_p)


def test_bridge_preserves_sizes(graphs):
    ref_graph, port_graph = graphs
    assert len(ref_graph.nodes) == len(port_graph.nodes) > 100
    for rv, pv in zip(ref_graph.values, port_graph.values):
        assert repr(rv.nbytes_expr) == repr(pv.nbytes_expr)
    assert port_graph.free_symbols() == ref_graph.free_symbols() == {"b", "s"}


def test_scheduled_order_and_decisions_identical(planned):
    rs, ps, sg_r, sg_p = planned
    assert [n.id for n in rs.order] == [n.id for n in ps.order]
    assert rs.symbolic_decisions == ps.symbolic_decisions
    assert rs.tiebreak_decisions == ps.tiebreak_decisions
    assert sg_r.cmp_stats == sg_p.cmp_stats


@pytest.mark.parametrize("env", ENVS, ids=lambda e: f"b{e['b']}s{e['s']}")
def test_simulate_peak_identical(graphs, planned, env):
    ref_graph, port_graph = graphs
    rs, ps, _, _ = planned
    for ro, po in ((ref_graph.nodes, port_graph.nodes), (rs.order, ps.order)):
        r, p = r_peak(ref_graph, ro, env), p_peak(port_graph, po, env)
        assert r.peak_bytes == p.peak_bytes
        assert r.steps == p.steps
        assert r.base_bytes == p.base_bytes


def test_simulate_peak_bound_identical(graphs, planned):
    ref_graph, port_graph = graphs
    rs, ps, sg_r, sg_p = planned
    r = r_bound(ref_graph, rs.order, sg_r)
    p = p_bound(port_graph, ps.order, sg_p)
    assert r == p
    assert r[1] is not None and r[1] >= r[0] > 0


def test_exchange_pass_identical(graphs, planned):
    ref_graph, port_graph = graphs
    rs, ps, _, _ = planned
    envs = [{"b": 8, "s": 64}, {"b": 2, "s": 16}, {"b": 32, "s": 256}]
    r = r_exchange(ref_graph, rs.order, envs)
    p = p_exchange(port_graph, ps.order, envs)
    assert [n.id for n in r] == [n.id for n in p]


@pytest.mark.parametrize("donate", [False, True])
def test_arena_plan_identical(graphs, planned, donate):
    ref_graph, port_graph = graphs
    rs, ps, sg_r, sg_p = planned
    r = r_arena(ref_graph, rs.order, sg_r, donate_inputs=donate)
    p = p_arena(port_graph, ps.order, sg_p, donate_inputs=donate)
    assert r.n_slots == p.n_slots > 0
    assert r.arena_bound_bytes == p.arena_bound_bytes
    assert r.arena_bound_lo == p.arena_bound_lo
    assert (r.n_provable_reuses, r.n_checked_reuses, r.n_donated_reuses) == \
        (p.n_provable_reuses, p.n_checked_reuses, p.n_donated_reuses)
    assert {v: a.sid for v, a in r.assignment.items()} == \
        {v: a.sid for v, a in p.assignment.items()}
    for env in ENVS:
        assert r.arena_bytes(env) == p.arena_bytes(env) <= p.arena_bound_bytes
