"""The port's observability against the reference's (``repro/core/obs``).

* **Bridged planning (exact).** On the reference's traced smoke
  ``llama2_1b`` train graph bridged into a port graph
  (``test_torch_planning.bridge``), the port's ``_compile_pipeline`` +
  ``lower_plan`` replay into the same per-instruction memory timeline as
  the reference's (every point's idx, step, opname, device_used,
  arena_in_use), the same planned per-step curve, the same diff peaks and
  no unexplained allocation; likewise the bounded programs of
  ``test_torch_bounded`` (measured and cap envs) and the rolled loops of
  ``test_torch_loops``.  On the same graph, whole range and buckets, the
  ``(kind, subject, choice)`` sequence of the decision log equals the
  reference's; ``kernel-select`` is compared by structure only (one entry
  per kernel node per plan: the port prices the Hopper model, the
  reference the TPU's), on the kernel_bench step.
* **Spans.** ``optimize`` records the reference's span names; nesting,
  thread-separate roots and the null tracer (twins of ``test_obs.py``).
* **Exact peak.** After a live call, ``memory_timeline(env)``'s replayed
  peak equals the plan's prediction and ``last_report.stats.device_peak``
  (the CPU prefill at smoke width, and a chain step).
* **The structural <=2% contract.** With telemetry off, ``tracemalloc``
  sees no allocation from ``core/obs`` over 5 calls, on the unbucketed
  and on the bucketed dispatch.
* **Ring, telemetry, hooks, est_cost, exports, explain.**
"""
import json
import os
import sys
import threading
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as R
import repro.core.symbolic as RS
import repro_torch.core.obs as obs_pkg
import repro_torch.core.symbolic as PS
from repro_torch.core import TensorSpec, optimize, spec_like, symbolic_dims
from repro_torch.core.api import _compile_pipeline
from repro_torch.core.dispatch import build_bucket_space
from repro_torch.core.lowering import lower_plan
from repro_torch.core.obs import (CallRecord, DecisionLog, NullTracer,
                                  Telemetry, TelemetryRing, Tracer,
                                  actual_timeline, chrome_trace,
                                  chrome_trace_json, diff_timeline,
                                  planned_timeline, prometheus_text)
from repro_torch.core.remat.runtime import RuntimeRematPolicy
from repro_torch.launch.serve import BucketBatcher
from test_torch_planning import ENVS, RANGES, bridge

f32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- shared compiled functions (compile once per module) ---------------------


def _chain(x):
    for _ in range(8):
        x = torch.tanh(x * 1.5 + 0.25)
    return x.sum()


def _bucketed_step(w, x):
    h = torch.tanh(x @ w)
    return (h * h).sum()


@pytest.fixture(scope="module")
def chain_fn():
    n, = symbolic_dims("n")
    return optimize(_chain, TensorSpec((n, 4), f32),
                    dynamic_dims={"n": (2, 256)}, device="cpu")


@pytest.fixture(scope="module")
def bucketed_fn():
    b, = symbolic_dims("b")
    return optimize(_bucketed_step, TensorSpec((8, 8), f32),
                    TensorSpec((b, 8), f32), dynamic_dims={"b": (1, 512)},
                    buckets={"b": [8, 64, 512]}, device="cpu")


@pytest.fixture(scope="module")
def loop_fn():
    from repro_torch.core import scan
    t, = symbolic_dims("t")

    def f(h0, xs):
        c0 = torch.tanh(h0)
        c_n, ys = scan(lambda c, x: (torch.tanh(c + x), c.sum()), c0, xs)
        return c_n.sum() + ys.sum()

    return optimize(f, TensorSpec((4,), f32), TensorSpec((t, 4), f32),
                    dynamic_dims={"t": (1, 64)}, device="cpu")


def _ones(*shape):
    return torch.ones(*shape, dtype=f32)


# -- bridged planning: timelines and the decision log -------------------------

# 2 x 2 geometric buckets over memplan_bench's ranges, and the whole range
# (test_torch_dispatch's bridged bucket cases)
BRIDGE_SPEC = {"b": 2, "s": 2}


def _points(tl):
    return [(p.idx, p.step, p.opname, p.device_used, p.arena_in_use)
            for p in tl.points]


def _decisions(dl):
    return [(d.kind, d.subject, d.choice) for d in dl.entries()]


@pytest.fixture(scope="module")
def bridged():
    """The smoke train graph planned and lowered by both packages (whole
    range), then compiled per bucket, one decision log per package."""
    from benchmarks.memplan_bench import _step_and_specs
    from repro.core.api import _compile_pipeline as r_pipeline
    from repro.core.ir import trace_to_graph
    from repro.core.lowering import lower_plan as r_lower
    from repro.core.obs import DecisionLog as RDecisionLog

    step, args = _step_and_specs("llama2_1b")
    ref_graph, _ = trace_to_graph(step, *args)
    port_graph = bridge(ref_graph)
    for rn, pn in zip(ref_graph.nodes, port_graph.nodes):
        if rn.prim_name == "dot_general":   # the form node_flops reads
            (lc, _rc), _ = rn.params["dimension_numbers"]
            pn.params["contracting_dims"] = (0, tuple(lc))
    sg_r, sg_p = RS.ShapeGraph(), PS.ShapeGraph()
    RS.declare_dim_ranges(sg_r, RANGES)
    PS.declare_dim_ranges(sg_p, RANGES)
    r_dl, p_dl = RDecisionLog(), DecisionLog()
    r_plan, r_rep, r_art = r_pipeline(ref_graph, sg_r, collect=True,
                                      kernel_select=False, decisions=r_dl)
    p_plan, p_rep, p_art = _compile_pipeline(port_graph, sg_p, collect=True,
                                             kernel_select=False,
                                             decisions=p_dl)
    r_prog = r_lower(r_plan, peak_bound_bytes=r_rep.peak_bound_bytes)
    p_prog = lower_plan(p_plan, peak_bound_bytes=p_rep.peak_bound_bytes)
    space = build_bucket_space(sg_p.declared_ranges, BRIDGE_SPEC)
    for key in list(space.keys()) + ["full"]:
        ranges = space.ranges_of(key) if key != "full" else \
            dict(sg_p.declared_ranges)
        r_ranges = {k: RS.Interval(v.lo, v.hi) for k, v in ranges.items()}
        r_pipeline(ref_graph, sg_r.specialized(r_ranges), parent=r_art,
                   kernel_select=False, decisions=r_dl)
        _compile_pipeline(port_graph, sg_p.specialized(ranges), parent=p_art,
                          kernel_select=False, decisions=p_dl)
    return dict(r_plan=r_plan, p_plan=p_plan, r_prog=r_prog, p_prog=p_prog,
                r_dl=r_dl, p_dl=p_dl)


@pytest.mark.parametrize("env", ENVS, ids=lambda e: f"b{e['b']}s{e['s']}")
def test_bridged_timelines_equal_reference(bridged, env):
    from repro.core.obs.timeline import actual_timeline as r_actual
    from repro.core.obs.timeline import diff_timeline as r_diff
    from repro.core.obs.timeline import planned_timeline as r_planned

    r_prog, p_prog = bridged["r_prog"], bridged["p_prog"]
    r_tl, p_tl = r_actual(r_prog, env), actual_timeline(p_prog, env)
    assert len(p_tl.points) == len(p_prog.fast_instructions) > 100
    assert _points(p_tl) == _points(r_tl)
    assert (p_tl.peak_device, p_tl.peak_arena_in_use, p_tl.arena_bytes) == \
        (r_tl.peak_device, r_tl.peak_arena_in_use, r_tl.arena_bytes)
    assert planned_timeline(p_prog, env) == r_planned(r_prog, env)
    rd, pd = r_diff(r_prog, env), diff_timeline(p_prog, env)
    assert rd.unexplained == pd.unexplained == []
    assert (pd.predicted_peak_device, pd.predicted_peak_arena,
            pd.arena_bound_bytes, pd.ok) == \
        (rd.predicted_peak_device, rd.predicted_peak_arena,
         rd.arena_bound_bytes, rd.ok)
    # the exact-peak contract, on both sides
    assert pd.actual.peak_device == pd.predicted_peak_device == \
        p_prog.resolve(env).stats_template.device_peak


def test_bridged_decision_log_equals_reference(bridged):
    r, p = _decisions(bridged["r_dl"]), _decisions(bridged["p_dl"])
    assert p == r
    kinds = {k for k, _, _ in p}
    # whole range: guard, exchange swaps, frozen remat methods, packing;
    # buckets: inherited schedule + remat where no verdict flips
    assert {"schedule-guard", "exchange-swap", "remat-static", "slot-pack",
            "bucket-reuse"} <= kinds, kinds
    # the details carry the same numbers too
    for rd, pd in zip(bridged["r_dl"].entries(), bridged["p_dl"].entries()):
        assert pd.why == rd.why
        assert repr(pd.detail) == repr(rd.detail)


def test_bridged_est_cost_equals_reference(bridged):
    """``EvictionDecision.est_cost`` for the same victims: the reference's
    and the port's runtime policies over the bridged whole-range plan."""
    from repro.core.remat.runtime import RuntimeRematPolicy as RPolicy
    r_plan, p_plan = bridged["r_plan"], bridged["p_plan"]
    env = {"b": 8, "s": 512}
    live = {vid: c.bytes_interval.hi for vid, c in p_plan.candidates.items()}
    for step in (len(p_plan.order) // 3, len(p_plan.order) // 2):
        need = sum(live.values()) // 2
        r = RPolicy(r_plan, env).choose_victims(need, live, frozenset(), step)
        p = RuntimeRematPolicy(p_plan, env).choose_victims(
            need, live, frozenset(), step)
        assert len(p) > 1
        assert [(d.vid, d.method, d.bytes_freed, d.est_cost) for d in p] == \
            [(d.vid, d.method, d.bytes_freed, d.est_cost) for d in r]


@pytest.fixture(scope="module")
def bridged_bounded():
    from test_torch_bounded import DIM_RANGE, _jax_fn
    out = {}
    for step in ("ragged_ffn", "filter_topk"):
        jf = _jax_fn(step)
        graph = bridge(jf.plan.graph)
        sg = PS.ShapeGraph()
        PS.declare_dim_ranges(sg, {"s": DIM_RANGE})
        for name, cap in graph.bound_dims.items():
            sg.declare_bound(name, cap)
        plan, report, _ = _compile_pipeline(graph, sg)
        out[step] = (jf, lower_plan(plan,
                                    peak_bound_bytes=report.peak_bound_bytes))
    return out


@pytest.mark.parametrize("step", ["ragged_ffn", "filter_topk"])
def test_bridged_bounded_timelines_equal_reference(bridged_bounded, step):
    from repro.core.obs.timeline import diff_timeline as r_diff
    from test_torch_bounded import N_ROWS, _np_args
    jf, prog = bridged_bounded[step]
    envs = [{"s": N_ROWS}]                       # the cap (no measured dim)
    for occ in (0.5, 0.0):
        jf(*[jnp.asarray(a) for a in _np_args(step, occ)])
        envs.append(dict(jf.last_report.env))    # the measured extents
    assert all(set(e) > {"s"} for e in envs[1:])   # "s" and the __b dims
    for env in envs:
        rd, pd = r_diff(jf.program, env), diff_timeline(prog, env)
        assert _points(pd.actual) == _points(rd.actual)
        assert (pd.predicted_device, pd.predicted_arena) == \
            (rd.predicted_device, rd.predicted_arena)
        assert pd.unexplained == rd.unexplained == []
        assert pd.ok and rd.ok
        assert "BindDim" in {p.opname for p in pd.actual.points}
        assert pd.actual.peak_device == pd.predicted_peak_device
    # a measured env's tight peak is the reference's live peak
    assert diff_timeline(prog, envs[1]).actual.peak_device == \
        jf.memory_timeline(envs[1]).actual.peak_device


@pytest.mark.parametrize("arch", ["llama2_1b", "musicgen_medium"])
def test_bridged_loop_timelines_equal_reference(arch):
    from benchmarks import loop_bench as LB
    from repro.core.obs.timeline import diff_timeline as r_diff
    t = R.symbolic_dim("t")
    _, p_specs, xs_spec = LB._cell(arch)
    jf = R.optimize(LB._rolled_fn(arch), p_specs, xs_spec(t),
                    dynamic_dims={"t": LB.NARROW})
    graph = bridge(jf.plan.graph)
    sg = PS.ShapeGraph()
    PS.declare_dim_ranges(sg, {"t": LB.NARROW})
    plan, report, _ = _compile_pipeline(graph, sg)
    prog = lower_plan(plan, peak_bound_bytes=report.peak_bound_bytes)
    loop_step, = [i.step for i in prog.instructions
                  if type(i).__name__ == "Loop"]
    liveness = prog.plan.arena_plan.liveness
    for T in (1, 2, 17, 64):
        env = {"t": T}
        rd, pd = r_diff(jf.program, env), diff_timeline(prog, env)
        assert _points(pd.actual) == _points(rd.actual)
        assert pd.unexplained == rd.unexplained == []
        assert "Loop" in {p.opname for p in pd.actual.points}
        # the planned curves agree at every step but the loop's, where the
        # reference also counts what the loop's own delta holds (the
        # intervals starting there): the port's prediction is exact
        born = sum(iv.nbytes_expr.evaluate(env) for iv in liveness.values()
                   if iv.start == loop_step)
        diff = [r - p for r, p in zip(rd.predicted_device,
                                      pd.predicted_device)]
        assert diff == [born if s == loop_step else 0
                        for s in range(len(diff))]
        assert born > 0
        assert pd.actual.peak_device == pd.predicted_peak_device == \
            rd.actual.peak_device == prog.resolve(env) \
            .stats_template.device_peak < rd.predicted_peak_device


# -- kernel-select: one decision per kernel node per plan ---------------------


def test_kernel_select_decisions_structure_matches_reference():
    """On the kernel_bench step, bucketed on s, every plan (whole range and
    each bucket) logs one ``kernel-select`` per kernel node, as the
    reference's does; the choices differ on purpose (cost models)."""
    from test_torch_serve import _kb_plans
    ref, port, _ = _kb_plans(buckets={"s": [64]})
    for fn in (ref, port):
        fn.specialization_table.warmup([{"b": 1, "s": 1},
                                        {"b": 1, "s": 2048}])
    r = [(d.kind, d.subject) for d in ref.decisions.entries("kernel-select")]
    p = [(d.kind, d.subject) for d in port.decisions.entries("kernel-select")]
    assert p == r
    assert len(p) == 3 * 2        # whole range + 2 buckets, 2 kernel nodes
    whole = port.decisions.entries("kernel-select")[:2]
    assert [d.choice for d in whole] == [
        sel.variant.name for _, sel in sorted(
            port.plan.kernel_selections.items())]
    for d in port.decisions.entries("kernel-select"):
        assert d.why.startswith("model ") and "us vs default" in d.why
        assert set(d.detail) == {"model_speedup", "n_scored", "invalid"}


def test_remeasure_logs_kernel_measure():
    """``remeasure_kernels`` records each node's measured re-selection."""
    from test_torch_serve import _kb_plans
    _, port, _ = _kb_plans(buckets={"s": [64]})
    forced = port.remeasure_kernels({"b": 1, "s": 16}, repeats=1)
    got = port.decisions.entries("kernel-measure")
    assert [d.choice for d in got] == [forced[int(d.subject.split()[0][1:])]
                                       for d in got]
    assert len(got) == 2 and all("timings_us" in d.detail for d in got)


# -- spans ---------------------------------------------------------------------


class TestTracer:
    def test_nesting_and_attrs(self):
        tr = Tracer()
        with tr.span("outer", kind="test") as o:
            with tr.span("inner") as i:
                i.attrs["n"] = 3
            o.attrs["done"] = True
        assert [r.name for r in tr.roots] == ["outer"]
        assert [s.name for s in tr.spans()] == ["outer", "inner"]
        outer = tr.roots[0]
        assert outer.attrs == {"kind": "test", "done": True}
        inner = outer.children[0]
        assert inner.attrs["n"] == 3
        assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
        assert tr.find("inner") == [inner]

    def test_thread_spans_are_separate_roots(self):
        tr = Tracer()

        def work():
            with tr.span("bg"):
                pass

        th = threading.Thread(target=work, name="specialize_0")
        with tr.span("fg"):
            th.start()
            th.join(timeout=10)
        assert not th.is_alive()
        assert [r.name for r in tr.roots] == ["fg", "bg"]
        assert tr.roots[0].children == []
        bg, = tr.find("bg")
        assert bg.thread_name == "specialize_0"
        assert bg.tid != tr.roots[0].tid

    def test_null_tracer_absorbs(self):
        tr = NullTracer()
        with tr.span("x", a=1) as sp:
            sp.attrs["b"] = 2
        assert tr.spans() == [] and tr.find("x") == []


def _ref_chain_and_bucketed():
    n, = R.symbolic_dims("n")

    def chain(x):
        for _ in range(8):
            x = jnp.tanh(x * 1.5 + 0.25)
        return x.sum()

    b, = R.symbolic_dims("b")

    def f(w, x):
        h = jnp.tanh(x @ w)
        return (h * h).sum()

    rc = R.optimize(chain, jax.ShapeDtypeStruct((n, 4), jnp.float32),
                    dynamic_dims={"n": (2, 256)})
    rb = R.optimize(f, jax.ShapeDtypeStruct((8, 8), jnp.float32),
                    jax.ShapeDtypeStruct((b, 8), jnp.float32),
                    dynamic_dims={"b": (1, 512)}, buckets={"b": [8, 64, 512]})
    rb(np.ones((8, 8), np.float32), np.ones((4, 8), np.float32))
    return rc, rb


def test_span_names_equal_reference(chain_fn, bucketed_fn):
    rc, rb = _ref_chain_and_bucketed()
    bucketed_fn(_ones(8, 8), _ones(4, 8))
    assert {s.name for s in chain_fn.trace.spans()} == \
        {s.name for s in rc.trace.spans()}
    assert {s.name for s in bucketed_fn.trace.spans()} == \
        {s.name for s in rb.trace.spans()}
    assert {"trace", "schedule", "exchange", "memplan", "remat",
            "kernel-select", "bounds", "lower", "specialize"} == \
        {s.name for s in bucketed_fn.trace.spans()}
    # phases nest: exchange under schedule; a bucket's pipeline and its
    # lowering under its specialize span
    sched = chain_fn.trace.find("schedule")[0]
    assert [c.name for c in sched.children] == ["exchange"]
    spec = bucketed_fn.trace.find("specialize")[0]
    assert spec.attrs["bucket"] == bucketed_fn.last_bucket
    assert spec.attrs["background"] is False
    assert [c.name for c in spec.children] == [
        "schedule", "memplan", "kernel-select", "bounds", "lower"]
    assert chain_fn.trace.find("memplan")[0].attrs["n_slots"] >= 1


def test_background_specialize_is_its_own_root():
    b, = symbolic_dims("b")
    fn = optimize(_bucketed_step, TensorSpec((8, 8), f32),
                  TensorSpec((b, 8), f32), dynamic_dims={"b": (1, 512)},
                  buckets={"b": [8, 64, 512]}, background_specialize=True,
                  device="cpu")
    fn(_ones(8, 8), _ones(4, 8))
    fn.drain_specializations(timeout=60)
    spec = fn.trace.find("specialize")
    assert len(spec) == 1 and spec[0].attrs["background"] is True
    assert spec[0] in fn.trace.roots
    assert spec[0].thread_name.startswith("specialize")
    assert spec[0].tid != fn.trace.roots[0].tid


# -- chrome trace ----------------------------------------------------------------


def _check_chrome(data):
    events = data["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    assert spans
    for e in spans:
        assert {"ts", "dur", "pid", "tid"} <= set(e) and e["dur"] >= 0
        for v in e["args"].values():       # JSON-safe attrs only
            assert isinstance(v, (int, float, str, bool, type(None)))
    return spans


def _check_nested(tracer):
    for root in tracer.roots:
        for s in root.walk():
            for c in s.children:
                assert s.t0_ns <= c.t0_ns <= c.t1_ns <= s.t1_ns


class TestChromeTrace:
    def test_export_is_valid_and_nested(self, bucketed_fn):
        bucketed_fn(_ones(8, 8), _ones(70, 8))
        spans = _check_chrome(json.loads(chrome_trace_json(bucketed_fn.trace)))
        assert len(spans) == len(bucketed_fn.trace.spans())
        _check_nested(bucketed_fn.trace)
        meta = [e for e in chrome_trace(bucketed_fn.trace)["traceEvents"]
                if e["ph"] == "M"]
        assert meta and all(e["name"] == "thread_name" for e in meta)

    def test_counter_events_from_timelines(self, chain_fn):
        diff = chain_fn.memory_timeline({"n": 8})
        data = chrome_trace(chain_fn.trace, timelines=[(0, diff.actual)])
        counters = [e for e in data["traceEvents"] if e["ph"] == "C"]
        assert len(counters) == len(diff.actual.points)
        assert [c["args"]["device_used"] for c in counters] == \
            [p.device_used for p in diff.actual.points]


# -- telemetry -----------------------------------------------------------------


def _rec(seq):
    return CallRecord(seq=seq, bucket_key=None, env=(("n", 8),),
                      wall_s=0.0, dispatch_ns=0, device_peak=0,
                      arena_bytes=0, evictions=0, recomputes=0,
                      reloads=0, donated_reuses=0, loop_trips=())


@settings(max_examples=40, deadline=None)
@given(cap=st.integers(1, 8), n=st.integers(0, 30))
def test_ring_is_exact_bounded_fifo(cap, n):
    ring = TelemetryRing(cap)
    for i in range(n):
        ring.push(_rec(i))
    recs = ring.records()
    assert len(ring) == min(n, cap)
    assert ring.total_pushed == n
    assert ring.dropped == max(0, n - cap)
    assert [r.seq for r in recs] == list(range(max(0, n - cap), n))


def test_ring_rejects_zero_capacity():
    with pytest.raises(ValueError):
        TelemetryRing(0)


def test_concurrent_pushes_lose_no_count(chain_fn):
    """8 threads, more than this machine's workers share, pushing into one
    ring and one Telemetry: no push and no counter increment is lost."""
    chain_fn(_ones(8, 4))
    report = chain_fn.last_report
    ring, tel = TelemetryRing(64), Telemetry(capacity=64)
    per = 500

    def work():
        for i in range(per):
            ring.push(_rec(i))
            tel.on_call(None, report)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert ring.total_pushed == tel.n_calls == tel.ring.total_pushed == \
        8 * per
    assert tel.calls_by_bucket == {None: 8 * per}
    assert sorted(r.seq for r in tel.ring.records()) == \
        list(range(8 * per - 64, 8 * per))


class TestTelemetry:
    def test_enable_record_disable(self, bucketed_fn):
        w = _ones(8, 8)
        tel = bucketed_fn.enable_telemetry(capacity=4,
                                           sample_timeline_every=2)
        try:
            for b in (2, 2, 30):
                bucketed_fn(w, _ones(b, 8))
                rep = bucketed_fn.last_report
                rec = tel.ring.records()[-1]
                assert rec.env == tuple(sorted(rep.env.items()))
                assert rec.bucket_key == bucketed_fn.last_bucket
                assert (rec.device_peak, rec.arena_bytes) == \
                    (rep.stats.device_peak, rep.stats.arena_bytes)
            assert tel.n_calls == 3
            recs = tel.ring.records()
            assert [r.seq for r in recs] == [0, 1, 2]
            assert recs[0].env == (("b", 2),)
            assert recs[0].bucket_key == recs[1].bucket_key != \
                recs[2].bucket_key
            assert [seq for seq, _tl in tel.timelines] == [0, 2]
            assert tel.timelines[1][1].peak_device == recs[2].device_peak
            assert tel.summary()["n_calls"] == 3
        finally:
            got = bucketed_fn.disable_telemetry()
        assert got is tel and bucketed_fn.telemetry is None

    def test_unbucketed_calls_are_recorded(self, chain_fn):
        tel = chain_fn.enable_telemetry(sample_timeline_every=1)
        try:
            chain_fn(_ones(8, 4))
            rec, = tel.ring.records()
            assert rec.bucket_key is None and rec.dispatch_ns == 0
            assert rec.device_peak == chain_fn.last_report.stats.device_peak
            assert tel.timelines[0][1].peak_device == rec.device_peak
        finally:
            chain_fn.disable_telemetry()

    def test_stats_split_semantics(self, bucketed_fn):
        tel = bucketed_fn.enable_telemetry()
        try:
            w, x = _ones(8, 8), _ones(2, 8)
            bucketed_fn(w, x)
            st1 = bucketed_fn.last_report.stats
            total1 = st1.dispatch_ns_total
            assert st1.last_dispatch_ns > 0
            assert total1 >= st1.last_dispatch_ns
            bucketed_fn(w, x)
            st2 = bucketed_fn.last_report.stats
            assert st2.dispatch_ns_total >= total1 + st2.last_dispatch_ns
            assert [r.dispatch_ns for r in tel.ring.records()] == \
                [st1.last_dispatch_ns, st2.last_dispatch_ns]
            assert tel.dispatch_ns_total == \
                st1.last_dispatch_ns + st2.last_dispatch_ns
            d = st2.as_dict()
            assert "last_dispatch_ns" in d and "dispatch_ns_total" in d
        finally:
            bucketed_fn.disable_telemetry()

    def test_loop_trips_recorded(self, loop_fn):
        tel = loop_fn.enable_telemetry()
        try:
            loop_fn(_ones(4), _ones(5, 4))
            assert tel.ring.records()[-1].loop_trips == (5,)
        finally:
            loop_fn.disable_telemetry()


def _obs_allocations(fn, args):
    obs_dir = os.path.dirname(obs_pkg.__file__)
    fn(*args)                                  # warm every cache
    flt = tracemalloc.Filter(True, os.path.join(obs_dir, "*"))
    tracemalloc.start(5)
    try:
        before = tracemalloc.take_snapshot().filter_traces([flt])
        for _ in range(5):
            fn(*args)
        after = tracemalloc.take_snapshot().filter_traces([flt])
    finally:
        tracemalloc.stop()
    return [d for d in after.compare_to(before, "lineno") if d.size_diff > 0]


def test_disabled_path_allocates_nothing_from_obs_unbucketed(chain_fn):
    """The structural <=2% contract: with telemetry off, a call touches no
    obs code at all (one attribute test, no allocation)."""
    assert chain_fn.telemetry is None
    grew = _obs_allocations(chain_fn, (_ones(4, 4),))
    assert not grew, f"obs code allocated on the disabled path: {grew}"


def test_disabled_path_allocates_nothing_from_obs_bucketed(bucketed_fn):
    assert bucketed_fn.telemetry is None
    grew = _obs_allocations(bucketed_fn, (_ones(8, 8), _ones(4, 8)))
    assert not grew, f"obs code allocated on the disabled path: {grew}"


def test_enabled_path_does_allocate_from_obs(chain_fn):
    """The tracemalloc probe sees obs code when it does run."""
    chain_fn.enable_telemetry()
    try:
        assert _obs_allocations(chain_fn, (_ones(4, 4),))
    finally:
        chain_fn.disable_telemetry()


# -- timelines -----------------------------------------------------------------


class TestTimeline:
    def test_plan_vs_actual_agree(self, chain_fn):
        for n in (2, 32, 256):
            diff = chain_fn.memory_timeline({"n": n})
            assert diff.ok and diff.unexplained == [] and diff.within_bound
            assert diff.actual.peak_device == diff.predicted_peak_device
            chain_fn(_ones(n, 4))
            assert diff.actual.peak_device == \
                chain_fn.last_report.stats.device_peak

    def test_prefill_peak_is_exact(self):
        """The port's CPU prefill at smoke width: after a live call at an
        env, the replayed peak = the plan's prediction = the call's
        device_peak (the reference's test_obs.py:284-293 on the port)."""
        from repro_torch.configs.llama2_1b import SMOKE
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.models import init_params
        params = init_params(SMOKE, seed=0, device="cpu")
        B, S = symbolic_dims("b, s")
        fn = optimize(make_prefill_step(SMOKE), spec_like(params),
                      {"tokens": TensorSpec((B, S), torch.int32)},
                      dynamic_dims={"b": (1, 8), "s": (16, 128)},
                      device="cpu")
        rng = np.random.RandomState(0)
        for b, s in ((1, 16), (3, 96), (8, 128)):
            tok = torch.from_numpy(rng.randint(0, SMOKE.vocab, (b, s))
                                   .astype(np.int32))
            fn(params, {"tokens": tok})
            diff = fn.memory_timeline({"b": b, "s": s})
            assert diff.ok, diff.summary()
            assert diff.actual.peak_device == diff.predicted_peak_device == \
                fn.last_report.stats.device_peak
            assert diff.actual.arena_bytes == \
                fn.last_report.stats.arena_bytes

    def test_loop_timeline_audits_clean(self, loop_fn):
        for t in (1, 5, 64):
            diff = loop_fn.memory_timeline({"t": t})
            assert diff.ok and diff.unexplained == []
            assert "Loop" in {p.opname for p in diff.actual.points}
            loop_fn(_ones(4), _ones(t, 4))
            assert diff.actual.peak_device == diff.predicted_peak_device == \
                loop_fn.last_report.stats.device_peak

    def test_bucketed_timeline_uses_resident_bucket(self, bucketed_fn):
        bucketed_fn(_ones(8, 8), _ones(4, 8))
        diff = bucketed_fn.memory_timeline({"b": 4})
        assert diff.ok, diff.summary()
        assert diff.arena_bound_bytes <= bucketed_fn.arena_bound_bytes
        assert diff.actual.peak_device == \
            bucketed_fn.last_report.stats.device_peak

    def test_reference_executor_has_no_timeline(self):
        n, = symbolic_dims("n")
        fn = optimize(lambda x: (x * x).sum(), TensorSpec((n,), f32),
                      dynamic_dims={"n": (2, 16)}, executor="reference",
                      device="cpu")
        with pytest.raises(ValueError, match='executor="vm"'):
            fn.memory_timeline({"n": 4})


def _pressure_step(x, w):
    a = torch.tanh(x @ w)
    b = torch.tanh(a @ w)
    c = torch.tanh(b @ w)
    d = torch.tanh(c @ w)
    return (a * d).sum() + (b * c).sum()


def test_timeline_hook_vm_and_interpreter_agree():
    """On the dynamic stream under a limit that evicts, the VM calls the
    hook after every instruction and the interpreter after every node;
    at each node's last instruction the two read the same device_used."""
    n, = symbolic_dims("n")
    specs = (TensorSpec((n, 64), f32), TensorSpec((64, 64), f32))
    vm = optimize(_pressure_step, *specs, dynamic_dims={"n": (1, 256)},
                  device="cpu")
    ref = optimize(_pressure_step, *specs, dynamic_dims={"n": (1, 256)},
                   device="cpu", executor="reference")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(256, 64).astype(np.float32))
    w = torch.from_numpy((rng.randn(64, 64) * 0.1).astype(np.float32))
    vm(x, w)
    peak = vm.last_report.stats.device_peak
    cap = peak - 256 * 64 * 4            # one activation less than the peak
    vm_c, ref_c = vm.with_memory_limit(cap), ref.with_memory_limit(cap)
    seen_vm, seen_ref = [], []
    vm_c.interp.timeline_hook = \
        lambda idx, inst, mm: seen_vm.append((idx, inst, mm.stats.device_used))
    ref_c.interp.timeline_hook = \
        lambda i, node, mm: seen_ref.append((i, node.id,
                                             mm.stats.device_used))
    out_vm, out_ref = vm_c(x, w), ref_c(x, w)
    assert torch.equal(out_vm, out_ref)
    assert vm_c.last_report.stats.evictions > 0
    prog = vm_c.program
    assert [i for i, _, _ in seen_vm] == list(range(len(prog.instructions)))
    assert [i for i, _, _ in seen_ref] == list(range(len(prog.plan.order)))
    # the VM's reading after the last instruction of each schedule step
    pos, step, last = prog.plan.pos, -1, {}
    for _idx, inst, used in seen_vm:
        node = getattr(inst, "node", None)
        if node is not None:
            step = pos[node.id]
        elif hasattr(inst, "step") and inst.step >= 0:
            step = inst.step
        if step >= 0 and type(inst).__name__ != "Return":
            last[step] = used
    assert [last[i] for i in range(len(prog.plan.order))] == \
        [used for _, _, used in seen_ref]
    assert max(used for *_, used in seen_vm) == \
        vm_c.last_report.stats.device_peak <= cap
    # the fast stream is never instrumented
    seen_vm.clear()
    vm.interp.timeline_hook = seen_vm.append
    vm(x, w)
    assert seen_vm == []


@pytest.mark.parametrize("executor", ["vm", "reference"])
def test_dynamic_stream_releases_the_call_on_return(executor):
    """Under a limit that evicts, a call's outputs die with the caller's
    last reference: the executor keeps none (the live per-instruction
    allocator reading of chip_smoke's phase 10 found a capped step's
    outputs held until a garbage collection)."""
    import gc
    import weakref
    n, = symbolic_dims("n")
    fn = optimize(_pressure_step, TensorSpec((n, 64), f32),
                  TensorSpec((64, 64), f32), dynamic_dims={"n": (1, 256)},
                  device="cpu", executor=executor)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(256, 64).astype(np.float32))
    w = torch.from_numpy((rng.randn(64, 64) * 0.1).astype(np.float32))
    fn(x, w)
    capped = fn.with_memory_limit(fn.last_report.stats.device_peak -
                                  256 * 64 * 4)
    enabled = gc.isenabled()
    gc.disable()
    try:
        out = capped(x, w)
        assert capped.last_report.stats.evictions > 0
        ref = weakref.ref(out)
        del out
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


# -- explain + serve surfaces --------------------------------------------------


class TestExplain:
    def test_report_sections(self, bucketed_fn):
        bucketed_fn(_ones(8, 8), _ones(4, 8))
        text = bucketed_fn.explain(env={"b": 4})
        for needle in ("compile phases", "decisions", "arena slots",
                       "rematerialization", "bucket dispatch",
                       "resilience", "not enabled", "plan vs actual",
                       "verdict: OK"):
            assert needle in text, f"explain() lacks {needle!r}"

    def test_explain_without_env(self, chain_fn):
        text = chain_fn.explain()
        assert "compile phases" in text
        assert "plan vs actual" not in text

    def test_kernel_selection_and_bound_dims_sections(self):
        from repro_torch.kernels import flash_attention, masked_select, rmsnorm
        b, s = symbolic_dims("b, s")

        def fwd(q, x, scale, mask):
            rows, cnt = masked_select(x, mask)
            return flash_attention(q, q, q, True, None, None), \
                rmsnorm(rows, scale, 1e-6, None), cnt

        fn = optimize(fwd, TensorSpec((b, 2, 16, 32), f32),
                      TensorSpec((s, 32), f32), TensorSpec((32,), f32),
                      TensorSpec((s,), torch.bool),
                      dynamic_dims={"b": (1, 4), "s": (1, 64)}, device="cpu")
        mask = torch.arange(64) < 20
        fn(_ones(2, 2, 16, 32), _ones(64, 32), _ones(32), mask)
        text = fn.explain(env=fn.last_report.env)
        assert "-- kernel selection" in text
        assert "flash_attention" in text and "rmsnorm" in text
        assert "-- value-dependent bounded dims" in text
        assert "measured 20" in text and "reserved" in text
        assert "verdict: OK" in text


def _families(text):
    families = {}
    for ln in (ln for ln in text.splitlines() if ln):
        if ln.startswith("# TYPE"):
            _, _, name, kind = ln.split()
            families[name] = kind
        elif not ln.startswith("#"):
            name = ln.split("{")[0].split(" ")[0]
            assert name in families, f"sample before TYPE: {ln}"
            float(ln.rsplit(" ", 1)[1])
    return families


class TestServeSurfaces:
    def test_prometheus_text(self, bucketed_fn):
        bucketed_fn(_ones(8, 8), _ones(4, 8))
        bat = BucketBatcher(bucketed_fn, memory_budget=1)
        bat.submit({"b": 2})
        bat.drain()
        families = _families(bat.metrics_text())
        assert families["repro_bucket_hits_total"] == "counter"
        assert families["repro_batcher_held_total"] == "counter"
        assert families["repro_bucket_arena_bound_bytes"] == "gauge"
        assert families["repro_quarantined_buckets"] == "gauge"
        assert "repro_calls_total" not in families
        assert "repro_degraded_calls_total" not in families

    def test_prometheus_with_telemetry(self, bucketed_fn):
        tel = bucketed_fn.enable_telemetry()
        try:
            bucketed_fn(_ones(8, 8), _ones(4, 8))
            text = prometheus_text(fn=bucketed_fn)
            assert "repro_calls_total 1" in text
            assert "repro_dispatch_ns_total" in text
            _families(text)
        finally:
            bucketed_fn.disable_telemetry()
        assert tel.n_calls == 1

    def test_prometheus_unbucketed_function(self, chain_fn):
        families = _families(prometheus_text(fn=chain_fn, prefix="port"))
        assert set(families) == {"port_arena_bound_bytes"}
