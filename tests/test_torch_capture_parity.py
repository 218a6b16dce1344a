"""Capture parity: the constructs the port's capture once refused, against
the reference.

A scan the roll gate refuses becomes one opaque node, as the reference's
trace keeps it (``repro/core/ir/trace.py:181-204``), and an op that meets
a bounded dim with a full-extent one pads the tight operand to the cap,
its output at the cap (``_propagate``, ``trace.py:103-145``).  The same
seeded numpy inputs go through the JAX functions and their torch twins:

* ``static``: ``scan(h + x)`` over a static length; ``passthrough``: a
  carry passed to another slot, ``(c1, c2) -> (c2, c1 + x)``;
  ``nested``: a static inner scan inside a symbolic-length outer one (the
  outer rolled, the inner opaque in its body), and ``nested_static``
  inside a static one (one opaque node, whose body runs the inner scan
  through the same loop); ``mixed``: ``masked_select`` rows + x.  For each: the port's ``optimize`` output against the
  reference's (2e-4, f32; bitwise for ``mixed``) and against its own
  eager function (bitwise); the VM equal to the interpreter bitwise with
  identical stats; and on the reference's graph bridged into a port graph
  (``test_torch_planning.bridge``), the port's schedule, remat
  candidates, slots, bounds, instruction counts, ``device_peak`` and
  ``arena_bytes`` equal to the reference's.
* ``symbolic_body`` (a static-length scan whose carry has a symbolic
  ``b``) and ``bounded_body`` / ``bounded_body_t`` (``masked_select`` in
  the body, over a static and a symbolic length): the reference plans
  them and raises at the first call (``TypeError`` from ``while_loop``,
  ``NotImplementedError`` for ``masked_select``'s lowering); the port
  runs them bitwise equal to its eager function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro.core as R
import repro_torch.core.symbolic as PS
from repro.core.ir.loop import loop_body_of as j_loop_body_of
from repro.kernels import masked_select as j_masked_select
from repro_torch.core import TensorSpec, optimize, scan, symbolic_dims
from repro_torch.core.api import _compile_pipeline
from repro_torch.core.ir.loop import OpaqueScan, loop_body_of
from repro_torch.core.lowering import lower_plan
from repro_torch.kernels import masked_select
from test_torch_planning import bridge

TOL = 2e-4
RANGES = {"b": (1, 8), "t": (1, 8), "s": (1, 64)}


# -- the constructs, in both packages --------------------------------------------


def j_static(h0, xs):
    return R.scan(lambda h, x: (h + x, jnp.sum(h, -1)), h0, xs)


def p_static(h0, xs):
    return scan(lambda h, x: (h + x, h.sum(-1)), h0, xs)


def j_passthrough(c0, xs):
    def body(c, x):
        c1, c2 = c
        return (c2, c1 + x), jnp.sum(c1, -1)
    return R.scan(body, (c0, c0 * 2.0), xs)


def p_passthrough(c0, xs):
    def body(c, x):
        c1, c2 = c
        return (c2, c1 + x), c1.sum(-1)
    return scan(body, (c0, c0 * 2.0), xs)


def j_nested(h0, xs):
    def outer(h, x):
        h2, ys = R.scan(lambda a, y: (jnp.tanh(a + y), a * 2.0), h, x)
        return h2, jnp.sum(ys, 0)
    return R.scan(outer, h0, xs)


def p_nested(h0, xs):
    def outer(h, x):
        h2, ys = scan(lambda a, y: (torch.tanh(a + y), a * 2.0), h, x)
        return h2, ys.sum(0)
    return scan(outer, h0, xs)


def j_mixed(x, mask):
    rows, cnt = j_masked_select(x, mask)
    return rows + x, cnt


def p_mixed(x, mask):
    rows, cnt = masked_select(x, mask)
    return rows + x, cnt


def j_bounded_body(h0, xs, mask):
    def body(h, x):
        rows, _ = j_masked_select(x, mask)
        return h + jnp.sum(rows, 0), jnp.sum(h, -1)
    return R.scan(body, h0, xs)


def p_bounded_body(h0, xs, mask):
    def body(h, x):
        rows, _ = masked_select(x, mask)
        return h + rows.sum(0), h.sum(-1)
    return scan(body, h0, xs)


# name -> (jax fn, torch fn, specs, envs): a spec is (shape, dtype) with
# dims as ints or names of RANGES; an env binds the names for one call
CASES = {
    "static": (j_static, p_static,
               [((2, 4), "f32"), ((3, 2, 4), "f32")], [{}]),
    "passthrough": (j_passthrough, p_passthrough,
                    [((2, 4), "f32"), ((3, 2, 4), "f32")], [{}]),
    "nested": (j_nested, p_nested,
               [((2, 4), "f32"), (("t", 3, 2, 4), "f32")],
               [{"t": 1}, {"t": 5}]),
    "nested_static": (j_nested, p_nested,
                      [((2, 4), "f32"), ((4, 3, 2, 4), "f32")], [{}]),
    "mixed": (j_mixed, p_mixed, [(("s", 4), "f32"), (("s",), "bool")],
              [{"s": 10}, {"s": 1}, {"s": 37}]),
}
# planned by the reference, which raises at the first call
RAISING = {
    "symbolic_body": (j_static, p_static,
                      [(("b", 4), "f32"), ((3, "b", 4), "f32")],
                      [{"b": 1}, {"b": 5}], TypeError, "while_loop"),
    "bounded_body": (j_bounded_body, p_bounded_body,
                     [((4,), "f32"), ((3, 6, 4), "f32"), ((6,), "bool")],
                     [{}], NotImplementedError, "masked_select"),
    "bounded_body_t": (j_bounded_body, p_bounded_body,
                       [((4,), "f32"), (("t", 6, 4), "f32"),
                        ((6,), "bool")],
                       [{"t": 1}, {"t": 6}], NotImplementedError,
                       "masked_select"),
}
ALL = {**CASES, **{k: v[:4] for k, v in RAISING.items()}}


def _names(specs):
    return sorted({d for shape, _ in specs for d in shape
                   if isinstance(d, str)})


def _ranges(specs):
    return {n: RANGES[n] for n in _names(specs)}


def _j_specs(specs):
    names = _names(specs)
    sym = dict(zip(names, R.symbolic_dims(", ".join(names)))) if names \
        else {}
    return [jax.ShapeDtypeStruct(tuple(sym.get(d, d) for d in shape),
                                 jnp.float32 if dt == "f32" else jnp.bool_)
            for shape, dt in specs]


def _p_specs(specs):
    names = _names(specs)
    sym = dict(zip(names, symbolic_dims(", ".join(names)))) if names else {}
    return [TensorSpec(tuple(sym.get(d, d) for d in shape),
                       torch.float32 if dt == "f32" else torch.bool)
            for shape, dt in specs]


def _np_args(specs, env, seed):
    rng = np.random.RandomState(seed)
    out = []
    for shape, dt in specs:
        shape = tuple(env.get(d, d) for d in shape)
        out.append(rng.randn(*shape).astype(np.float32) if dt == "f32"
                   else rng.rand(*shape) > 0.5)
    return out


def _torch(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _bitwise(a, b):
    a, b = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def plans():
    """name -> (reference optimize, port VM plan, port interpreter plan)."""
    out = {}
    for name, (jf, pf, specs, _) in ALL.items():
        ranges = _ranges(specs)
        out[name] = (
            R.optimize(jf, *_j_specs(specs), dynamic_dims=ranges),
            optimize(pf, *_p_specs(specs), dynamic_dims=ranges,
                     device="cpu"),
            optimize(pf, *_p_specs(specs), dynamic_dims=ranges,
                     device="cpu", executor="reference"))
    return out


# -- numerics ----------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_matches_reference_and_eager(plans, name):
    _, pf, specs, envs = CASES[name]
    jfn, fn, _ = plans[name]
    for i, env in enumerate(envs):
        args = _np_args(specs, env, seed=i)
        want = _leaves(jfn(*[jnp.asarray(a) for a in args]))
        got = fn(*_torch(args))
        leaves = [x.numpy() for x in pytree.tree_leaves(got)]
        assert [x.shape for x in leaves] == [x.shape for x in want]
        for g, w in zip(leaves, want):
            if name == "mixed":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        if name == "mixed":
            x, mask = _torch(args)
            rows = x[mask]
            eager = torch.cat([rows, x.new_zeros(len(x) - len(rows), 4)]) + x
            assert torch.equal(got[0], eager)
        else:
            assert _bitwise(got, pf(*_torch(args)))


@pytest.mark.parametrize("name", ALL)
def test_vm_equals_interpreter(plans, name):
    _, _, specs, envs = ALL[name]
    _, fn, ref = plans[name]
    for i, env in enumerate(envs):
        args = _np_args(specs, env, seed=10 + i)
        assert _bitwise(fn(*_torch(args)), ref(*_torch(args)))
        assert fn.last_report.stats.as_dict() == \
            ref.last_report.stats.as_dict()


@pytest.mark.parametrize("name", RAISING)
def test_reference_raises_where_the_port_runs(plans, name):
    _, pf, specs, envs, exc, match = RAISING[name]
    jfn, fn, _ = plans[name]
    assert [n.prim_name for n in jfn.plan.graph.nodes] == ["scan"]
    for i, env in enumerate(envs):
        args = _np_args(specs, env, seed=20 + i)
        with pytest.raises(exc, match=match):
            jfn(*[jnp.asarray(a) for a in args])
        assert _bitwise(fn(*_torch(args)), pf(*_torch(args)))


# -- the graphs --------------------------------------------------------------------


def _opaque(graph):
    return [n for n in graph.nodes if isinstance(n.prim, OpaqueScan)]


@pytest.mark.parametrize("name", ["static", "passthrough", "nested_static",
                                  "symbolic_body", "bounded_body",
                                  "bounded_body_t"])
def test_refused_scan_is_one_opaque_node(plans, name):
    """The node reads every input of the scan, writes its outputs at the
    fakes' shapes and carries no loop body, as the reference's."""
    jfn, fn, _ = plans[name]
    g = fn.plan.graph
    (node,) = [n for n in g.nodes if n.prim_name == "scan"]
    assert _opaque(g) == [node] and loop_body_of(node) is None
    assert fn.program.counts()["Loop"] == 0
    (jnode,) = [n for n in jfn.plan.graph.nodes if n.prim_name == "scan"]
    assert [[str(d) for d in v.dims] for v in node.outvals] == \
        [[str(d) for d in v.dims] for v in jnode.outvals]
    assert fn.report.guards == []


def test_nested_scan_rolls_the_outer_keeps_the_inner_opaque(plans):
    jfn, fn, _ = plans["nested"]
    (loop,) = fn.plan.graph.nodes
    body = loop_body_of(loop)
    assert body is not None and fn.program.counts()["Loop"] == 1
    assert [n.prim_name for n in _opaque(body.graph)] == ["scan"]
    (jloop,) = jfn.plan.graph.nodes
    jbody = j_loop_body_of(jloop).graph
    assert [n.prim_name for n in jbody.nodes].count("scan") == 1
    assert j_loop_body_of(jbody.nodes[0]) is None


def test_mixed_op_pads_to_the_cap_and_stays_exact_elsewhere():
    """Only the op that meets the full extent reads a padded operand: a
    tight consumer keeps the bound dim, and ``device_peak`` counts the
    tight payload, the cap-sized pad and the add's output."""
    def f(x, mask):
        rows, cnt = masked_select(x, mask)
        return rows + x, torch.tanh(rows).sum(0), cnt

    S, = symbolic_dims("s")
    fn = optimize(f, TensorSpec((S, 4), torch.float32),
                  TensorSpec((S,), torch.bool), dynamic_dims={"s": (1, 64)},
                  device="cpu")
    dims = {n.prim_name: [str(d) for d in n.outvals[0].dims]
            for n in fn.plan.graph.nodes}
    assert dims["aten.constant_pad_nd.default"] == ["s", "4"]
    assert dims["aten.add.Tensor"] == ["s", "4"]
    assert dims["aten.tanh.default"] == ["__b0", "4"]
    for n_sel in (0, 3, 10):
        x = torch.randn(10, 4)
        mask = torch.arange(10) < n_sel
        out, tanh_sum, cnt = fn(x, mask)
        assert int(cnt) == n_sel and out.shape == (10, 4)
        assert torch.equal(tanh_sum, torch.tanh(x[:n_sel]).sum(0))
        st = fn.last_report.stats
        assert st.measured_dims == {"__b0": n_sel}
        assert 0 < st.device_peak <= fn.guaranteed_peak_bytes


def test_opaque_node_timeline_is_one_instruction(plans):
    """``memory_timeline`` replays the opaque node as one instruction: the
    replayed peak = the plan's prediction = the live call's
    ``device_peak``."""
    _, _, specs, envs, _, _ = RAISING["symbolic_body"]
    fn = plans["symbolic_body"][1]
    for i, env in enumerate(envs):
        diff = fn.memory_timeline(env)
        assert diff.ok and diff.unexplained == [], diff.summary()
        assert [p.opname for p in diff.actual.points] == \
            ["BindArg", "BindArg", "Compute", "Return"]
        fn(*_torch(_np_args(specs, env, seed=30 + i)))
        assert diff.actual.peak_device == diff.predicted_peak_device == \
            fn.last_report.stats.device_peak


def test_an_opaque_node_is_recomputed_under_a_limit():
    """Remat treats the opaque node as the reference's search does, as an
    op: its output is a candidate whose recompute subgraph is the node,
    ``export_regen_programs`` lowers it, and a limit just under the peak
    regenerates it bitwise, on the VM and the interpreter alike."""
    n = 64

    def f(w, xs, v):
        c, _ = scan(lambda h, x: (torch.tanh(h + x), h.sum(-1)), w, xs)
        y = torch.tanh(v @ v)
        y = torch.tanh(y @ y)
        return (y[:n, :n] * c).sum(), c.sum()

    f32 = torch.float32
    specs = (TensorSpec((n, n), f32), TensorSpec((3, n, n), f32),
             TensorSpec((4 * n, 4 * n), f32))
    base = optimize(f, *specs, device="cpu")
    (scan_node,) = _opaque(base.plan.graph)
    assert any(c.recompute is not None
               and c.recompute.node_ids == (scan_node.id,)
               for c in base.plan.candidates.values())
    rng = np.random.RandomState(3)
    args = _torch([rng.randn(n, n).astype(np.float32),
                   rng.randn(3, n, n).astype(np.float32),
                   (0.05 * rng.randn(4 * n, 4 * n)).astype(np.float32)])
    want = base(*args)
    limit = base.last_report.stats.device_peak - 8192
    vm, ref = (optimize(f, *specs, device="cpu", memory_limit=limit,
                        executor=ex) for ex in ("vm", "reference"))
    assert [type(step.prim) for rp in vm.program.regen.values()
            for step in rp.steps] == [OpaqueScan]
    assert _bitwise(vm(*args), want) and _bitwise(ref(*args), want)
    st = vm.last_report.stats
    assert st.recomputes == 1 and st.device_peak <= limit
    assert st.as_dict() == ref.last_report.stats.as_dict()


def test_an_earlier_static_capture_does_not_pin_a_symbolic_dim():
    """torch compiles a scan with dynamo, whose cache outlives a capture:
    the same body captured at a static shape and then with a symbolic
    ``b`` traced at the same size must keep ``b`` symbolic."""
    B, = symbolic_dims("b")
    f32 = torch.float32
    optimize(p_static, TensorSpec((2, 4), f32), TensorSpec((3, 2, 4), f32),
             device="cpu")
    fn = optimize(p_static, TensorSpec((B, 4), f32),
                  TensorSpec((3, B, 4), f32), dynamic_dims={"b": (1, 8)},
                  device="cpu")
    assert fn.plan.graph.free_symbols() == {"b"}
    h0, xs = torch.randn(5, 4), torch.randn(3, 5, 4)
    assert _bitwise(fn(h0, xs), p_static(h0, xs))


def test_scan_output_sized_by_its_body_values_is_refused():
    def f(xs, mask):
        def body(h, x):
            rows, _ = masked_select(x, mask)
            return h + 1.0, rows * 2.0
        return scan(body, torch.zeros(()), xs)

    with pytest.raises(NotImplementedError, match="inside its body"):
        optimize(f, TensorSpec((3, 6), torch.float32),
                 TensorSpec((6,), torch.bool), device="cpu")


# -- bridged planning --------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_bridged_planning_equals_reference(plans, name):
    _, _, specs, envs = CASES[name]
    jfn = plans[name][0]
    graph = bridge(jfn.plan.graph)
    sg = PS.ShapeGraph()
    PS.declare_dim_ranges(sg, _ranges(specs))
    for bname, cap in graph.bound_dims.items():
        sg.declare_bound(bname, cap)
    plan, report, _ = _compile_pipeline(graph, sg)
    prog = lower_plan(plan, peak_bound_bytes=report.peak_bound_bytes)
    assert [n.id for n in plan.order] == [n.id for n in jfn.plan.order]
    assert sorted(plan.candidates) == sorted(jfn.plan.candidates)
    assert report.n_arena_slots == jfn.report.n_arena_slots
    assert report.arena_bound_bytes == jfn.report.arena_bound_bytes
    assert report.peak_bound_bytes == jfn.report.peak_bound_bytes
    assert prog.counts() == jfn.program.counts()
    for i, env in enumerate(envs):
        jfn(*[jnp.asarray(a) for a in _np_args(specs, env, seed=i)])
        jst = jfn.last_report.stats
        pst = prog.stats_for(prog.resolve(dict(env)),
                             dict(jst.measured_dims) or None)
        assert (pst.device_peak, pst.arena_bytes) == \
            (jst.device_peak, jst.arena_bytes)
