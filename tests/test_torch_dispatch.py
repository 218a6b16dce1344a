"""The port's bucketed dispatch against the reference's.

Mirrors ``tests/test_dispatch.py``:

* **The partition.** Bucket edges, ``key_of``, sub-ranges and labels
  equal the reference's for every spec form (``True``, ``"geometric"``,
  an int, a mapping of counts, explicit edges) over hypothesis-drawn
  declared ranges, and the same bad specs raise the same errors.
* **Incremental per-bucket planning on bridged graphs.** On the
  reference's traced smoke ``llama2_1b`` train graph bridged into a port
  ``Graph`` (``test_torch_planning``), each bucket's pipeline run with the
  whole-range compile as its parent gives the reference's scheduled
  order, remat candidates, reuse flags, ``arena_bound_bytes`` and
  ``peak_bound_bytes``; each bucket's bounds are no worse than the whole
  range's.
* **The table.** The hit path never replans, LRU eviction recompiles,
  bounds survive eviction, ``warmup`` makes the first call a hit, a
  background miss is served by the whole-range fallback until the drain,
  and a failing compile quarantines its bucket.
* **End to end.** The bucketed smoke prefill matches the JAX prefill at
  2e-4 (f32); the bucketed smoke train step is bitwise equal to the
  unbucketed one.
* **The serving front end.** ``BucketBatcher`` groups by bucket, holds
  buckets over its budget without recompiling them, and refuses an
  out-of-range request at intake.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils import _pytree as pytree

import repro.core.symbolic as R
import repro_torch.core.symbolic as P
from repro.core.dispatch import build_bucket_space as r_space
from repro_torch.configs.llama2_1b import SMOKE
from repro_torch.core import TensorSpec, optimize, spec_like, symbolic_dims
from repro_torch.core.api import DynamicShapeFunction, _compile_pipeline
from repro_torch.core.dispatch import DimBuckets, build_bucket_space
from repro_torch.core.resilience import (BreakerConfig, BucketQuarantined,
                                         CircuitBreaker, CompileFault,
                                         RequestRejected)
from repro_torch.launch.serve import BucketBatcher
from repro_torch.launch.steps import (adamw_config_for, make_prefill_step,
                                      make_train_step)
from repro_torch.models import init_params, params_from_jax
from repro_torch.optim import init_state
from test_torch_planning import RANGES, bridge


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the partition ---------------------------------------------------------------


def _spaces(ranges, spec):
    """(reference outcome, port outcome): a BucketSpace or the exception."""
    out = []
    for mod, build in ((R, r_space), (P, build_bucket_space)):
        sg = mod.ShapeGraph()
        mod.declare_dim_ranges(sg, ranges)
        try:
            out.append(build(sg.declared_ranges, spec))
        except (ValueError, TypeError) as e:
            out.append(e)
    return out


def _dims(space):
    return [(d.name, d.lo, tuple(d.uppers)) for d in space.dims]


_SPECS = st.sampled_from(["true", "geometric", "int", "counts", "edges"])


@settings(max_examples=60, deadline=None)
@given(b_lo=st.integers(1, 16), b_span=st.integers(0, 300),
       s_lo=st.integers(1, 64), s_span=st.integers(0, 8192),
       kind=_SPECS, n=st.integers(1, 6),
       cuts=st.lists(st.integers(1, 9000), min_size=0, max_size=4),
       probes=st.lists(st.tuples(st.integers(0, 10**6), st.integers(0, 10**6)),
                       min_size=1, max_size=6))
def test_bucket_space_equals_reference(b_lo, b_span, s_lo, s_span, kind, n,
                                       cuts, probes):
    ranges = {"b": (b_lo, b_lo + b_span), "s": (s_lo, s_lo + s_span)}
    spec = {"true": True, "geometric": "geometric", "int": n,
            "counts": {"s": n, "b": max(1, n - 1)},
            "edges": {"s": cuts}}[kind]
    ref, port = _spaces(ranges, spec)
    if isinstance(ref, Exception):
        assert type(port) is type(ref) and str(port) == str(ref)
        return
    assert _dims(port) == _dims(ref)
    assert port.n_buckets == ref.n_buckets and port.dim_names == ref.dim_names
    for key in ref.keys():
        r_iv, p_iv = ref.ranges_of(key), port.ranges_of(key)
        assert {k: (v.lo, v.hi) for k, v in p_iv.items()} == \
            {k: (v.lo, v.hi) for k, v in r_iv.items()}
        assert port.describe(key) == ref.describe(key)
    for pb, ps in probes:
        env = {"b": b_lo + pb % (b_span + 1), "s": s_lo + ps % (s_span + 1)}
        assert port.key_of(env) == ref.key_of(env)


@pytest.mark.parametrize("ranges,spec", [
    ({}, "geometric"),
    ({"s": (8, 256)}, {"nope": 4}),
    ({"s": (8, 256)}, 1),
    ({"s": ">=4"}, 4),
    ({"s": (8, 256)}, False),
    ({"s": (8, 256)}, "bogus"),
    ({"s": (8, 256)}, {"s": True}),
    ({"s": (8, 256)}, {"s": [4]}),
    ({"s": (8, 256)}, {"s": 0}),
    ({"s": (8, 256)}, {"s": [300]}),
], ids=str)
def test_bad_specs_raise_like_reference(ranges, spec):
    ref, port = _spaces(ranges, spec)
    assert isinstance(ref, Exception)
    assert type(port) is type(ref) and str(port) == str(ref)


def test_edges_dispatch_to_the_lower_bucket_and_never_clamp():
    d = DimBuckets("s", 16, (64, 256, 1024))
    assert [d.index_of(v) for v in (16, 64, 65, 256, 257, 1024)] == \
        [0, 0, 1, 1, 2, 2]
    for v in (15, 1025):
        with pytest.raises(ValueError, match="outside the bucketed range"):
            d.index_of(v)
    ref, port = _spaces({"s": ">=4"}, {"s": [64]})
    assert _dims(port) == _dims(ref) == [("s", 4, (64, None))]
    assert port.key_of({"s": 10**7}) == (1,)


# -- incremental per-bucket planning on bridged graphs ----------------------------

# a mapping of counts: 2 x 2 geometric buckets over memplan_bench's ranges,
# and the whole declared range, under which no verdict flips (full reuse)
BRIDGE_SPEC = {"b": 2, "s": 2}
FULL_RANGE = {"b": RANGES["b"], "s": RANGES["s"]}


@pytest.fixture(scope="module")
def bridged_buckets():
    from benchmarks.memplan_bench import _step_and_specs
    from repro.core.api import _compile_pipeline as r_pipeline
    from repro.core.ir import trace_to_graph

    step, args = _step_and_specs("llama2_1b")
    ref_graph, _ = trace_to_graph(step, *args)
    port_graph = bridge(ref_graph)
    for rn, pn in zip(ref_graph.nodes, port_graph.nodes):
        if rn.prim_name == "dot_general":
            (lc, _rc), _ = rn.params["dimension_numbers"]
            pn.params["contracting_dims"] = (0, tuple(lc))
    sg_r, sg_p = R.ShapeGraph(), P.ShapeGraph()
    R.declare_dim_ranges(sg_r, RANGES)
    P.declare_dim_ranges(sg_p, RANGES)
    r_whole = r_pipeline(ref_graph, sg_r, collect=True, kernel_select=False)
    p_whole = _compile_pipeline(port_graph, sg_p, collect=True,
                                kernel_select=False)
    space = build_bucket_space(sg_p.declared_ranges, BRIDGE_SPEC)
    cases = {key: space.ranges_of(key) for key in space.keys()}
    cases["full"] = {k: P.Interval(*v) for k, v in FULL_RANGE.items()}
    out = {}
    for name, ranges in cases.items():
        r_ranges = {k: R.Interval(v.lo, v.hi) for k, v in ranges.items()}
        out[name] = (
            r_pipeline(ref_graph, sg_r.specialized(r_ranges),
                       parent=r_whole[2], kernel_select=False)[:2],
            _compile_pipeline(port_graph, sg_p.specialized(ranges),
                              parent=p_whole[2], kernel_select=False)[:2])
    return r_whole[:2], p_whole[:2], out


def _candidates(plan):
    return {vid: (c.recompute_pruned_by_bounds,
                  (c.bytes_interval.lo, c.bytes_interval.hi),
                  None if c.recompute is None else
                  (c.recompute.node_ids, c.recompute.source_ids,
                   c.recompute.impact_interval.lo,
                   c.recompute.impact_interval.hi))
            for vid, c in plan.candidates.items()}


@pytest.mark.parametrize("case", [(0, 0), (0, 1), (1, 0), (1, 1), "full"],
                         ids=str)
def test_bridged_bucket_pipeline_equals_reference(bridged_buckets, case):
    _, _, per_bucket = bridged_buckets
    (r_plan, r_rep), (p_plan, p_rep) = per_bucket[case]
    assert [n.id for n in p_plan.order] == [n.id for n in r_plan.order]
    assert _candidates(p_plan) == _candidates(r_plan)
    assert p_plan.static_methods == r_plan.static_methods
    assert (p_rep.reused_parent_schedule, p_rep.reused_parent_postpass) == \
        (r_rep.reused_parent_schedule, r_rep.reused_parent_postpass)
    assert (p_rep.arena_bound_bytes, p_rep.peak_bound_bytes,
            p_rep.peak_bound_lo) == \
        (r_rep.arena_bound_bytes, r_rep.peak_bound_bytes, r_rep.peak_bound_lo)
    assert p_rep.n_arena_slots == r_rep.n_arena_slots
    if case == "full":
        # narrowing to the declared range flips no verdict: full reuse
        assert p_rep.reused_parent_schedule


def test_bridged_bucket_bounds_not_above_whole_range(bridged_buckets):
    _, (_, whole), per_bucket = bridged_buckets
    bounds = [(rep.arena_bound_bytes, rep.peak_bound_bytes)
              for key, (_, (_, rep)) in per_bucket.items() if key != "full"]
    assert all(a <= whole.arena_bound_bytes and p <= whole.peak_bound_bytes
               for a, p in bounds)
    # the small-shape bucket is strictly cheaper — the point of bucketing
    assert min(a for a, _ in bounds) < whole.arena_bound_bytes
    assert min(p for _, p in bounds) < whole.peak_bound_bytes


# -- the specialization table (a tiny step: capture is cheap) ---------------------

TINY_RANGES = {"b": (1, 16), "s": (8, 256)}


def _tiny_step(x, w):
    return torch.relu(x @ w).sum(-1)


def _tiny(**kw):
    B, S = symbolic_dims("b, s")
    return optimize(_tiny_step, TensorSpec((B, S, 8), torch.float32),
                    TensorSpec((8, 8), torch.float32),
                    dynamic_dims=TINY_RANGES, device="cpu", **kw)


def _tiny_args(b, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, s, 8, generator=g), torch.randn(8, 8, generator=g)


def test_hit_path_never_replans():
    fn = _tiny(buckets={"s": [64]})
    table = fn.specialization_table
    args = _tiny_args(2, 16)
    fn(*args)
    assert table.specialize_count == 1 and table.hits == 0
    plan_before = table.peek(fn.last_bucket).plan
    for i in range(3):
        out = fn(*args)
        st = fn.last_report.stats
        assert st.specialize_count == 1 and st.bucket_hits == i + 1
        assert st.last_dispatch_ns > 0
        assert st.dispatch_ns_total >= st.last_dispatch_ns
        torch.testing.assert_close(out, _tiny_step(*args))
    assert table.peek(fn.last_bucket).plan is plan_before


def test_lru_eviction_recompiles_and_bounds_survive():
    fn = _tiny(buckets={"s": [16, 32, 64]}, max_cached_plans=2)
    table = fn.specialization_table
    bound0 = table.arena_bound_bytes((0, 0))            # compiles bucket 0
    for s in (30, 60):                                  # bucket 2 evicts 0
        fn(*_tiny_args(2, s))
    assert table.specialize_count == 3 and table.evictions == 1
    assert table.peek((0, 0)) is None and len(table.compiled_keys) == 2
    # the bound is remembered without recompiling
    assert table.arena_bound_bytes((0, 0)) == bound0
    assert table.specialize_count == 3
    args = _tiny_args(2, 12)
    torch.testing.assert_close(fn(*args), _tiny_step(*args))  # recompiles 0
    assert table.specialize_count == 4 and fn.last_bucket == (0, 0)


def test_warmup_makes_the_first_call_a_hit():
    fn = _tiny(buckets={"s": [64]})
    keys = fn.warmup([{"b": 2, "s": 16}, {"b": 4, "s": 20},
                      {"b": 2, "s": 100}])
    assert keys == [(0, 0), (0, 1)]
    table = fn.specialization_table
    assert table.specialize_count == 2 and table.hits == 0
    fn(*_tiny_args(2, 16))
    assert table.hits == 1 and table.specialize_count == 2
    with pytest.raises(ValueError, match="buckets"):
        _tiny().warmup([{"b": 2, "s": 16}])
    with pytest.raises(ValueError, match="outside the bucketed range"):
        fn.warmup([{"b": 2, "s": 5000}])


def test_background_miss_serves_the_fallback_until_the_drain():
    fn = _tiny(buckets={"s": [64]}, background_specialize=True)
    table = fn.specialization_table
    args = _tiny_args(3, 40)
    out = fn(*args)
    assert table.fallback_serves == 1
    assert fn.last_arena_bound == fn.arena_bound_bytes
    assert fn.last_bucket == (0, 0)
    # the drain joins the compile if it is still in flight
    assert fn.drain_specializations(timeout=60) in ([], [(0, 0)])
    assert table.specialize_count == 1 and table.n_pending == 0
    again = fn(*args)
    assert table.hits == 1 and table.fallback_serves == 1
    assert fn.last_arena_bound == table.peek((0, 0)).arena_bound_bytes
    assert torch.equal(out, again)
    torch.testing.assert_close(out, _tiny_step(*args))
    with pytest.raises(ValueError, match="buckets"):
        _tiny(background_specialize=True)


def test_a_failing_compile_quarantines_its_bucket(monkeypatch):
    import repro_torch.core.api as api
    fn = _tiny(buckets={"s": [64]})
    bg = _tiny(buckets={"s": [64]}, background_specialize=True)
    real = api._compile_pipeline

    def failing(graph, sg, **kw):
        if kw.get("parent") is not None and sg.declared_ranges["s"].lo == 65:
            raise CompileFault("injected compile failure")
        return real(graph, sg, **kw)

    monkeypatch.setattr(api, "_compile_pipeline", failing)
    for f in (fn, bg):   # a quarantine window that outlasts the test
        f.specialization_table.breaker = CircuitBreaker(
            BreakerConfig(backoff_s=600.0, max_backoff_s=600.0))
    big = _tiny_args(2, 100)
    with pytest.raises(CompileFault):
        fn(*big)
    with pytest.raises(BucketQuarantined):
        fn(*big)                      # inside the backoff: not recompiled
    assert fn.specialization_table.quarantined() == [(0, 1)]
    fn(*_tiny_args(2, 16))             # other buckets still compile
    # in the background the fallback keeps serving the quarantined bucket
    out = bg(*big)
    bg.drain_specializations(timeout=60)
    assert bg.specialization_table.quarantined() == [(0, 1)]
    assert torch.equal(bg(*big), out)
    assert bg.specialization_table.fallback_serves == 2


def test_out_of_range_env_raises_before_dispatch():
    fn = _tiny(buckets={"s": [64]})
    with pytest.raises(ValueError, match="declared range"):
        fn(*_tiny_args(2, 300))
    assert fn.specialization_table.misses == 0


def test_with_memory_limit_keeps_bucketing():
    fn = _tiny(buckets={"s": [64]})
    capped = fn.with_memory_limit(1 << 20)
    assert capped.specialization_table is not None
    assert capped.specialization_table is not fn.specialization_table
    args = _tiny_args(2, 16)
    torch.testing.assert_close(capped(*args), _tiny_step(*args))
    assert capped.last_bucket == (0, 0)
    bp = capped.specialization_table.peek((0, 0))
    assert bp.program.memory_limit == 1 << 20


# -- end to end: the smoke prefill against JAX, the train step bitwise ------------

DYNAMIC_DIMS = {"b": (1, 8), "s": (16, 128)}
PREFILL_EDGES = {"s": [32, 64]}


@pytest.fixture(scope="module")
def weights():
    from repro.configs.llama2_1b import SMOKE as JSMOKE
    from repro.models import init_params as jinit
    jcfg = dataclasses.replace(JSMOKE, scan_layers=False)
    jparams = jinit(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, params_from_jax(np_params, SMOKE, device="cpu")


@pytest.fixture(scope="module")
def bucketed(weights):
    _, _, params = weights
    B, S = symbolic_dims("b, s")
    return optimize(make_prefill_step(SMOKE), spec_like(params),
                    {"tokens": TensorSpec((B, S), torch.int32)},
                    dynamic_dims=DYNAMIC_DIMS, buckets=PREFILL_EDGES,
                    device="cpu")


def _tokens(b, s):
    return torch.from_numpy(np.random.RandomState(b * 1000 + s).randint(
        0, SMOKE.vocab, (b, s)).astype(np.int32))


@pytest.mark.parametrize("b,s,key", [(1, 16, (0, 0)), (2, 40, (0, 1)),
                                     (3, 96, (0, 2))])
def test_bucketed_prefill_matches_reference(weights, bucketed, b, s, key):
    from repro.models import prefill
    jcfg, jparams, params = weights
    tok = _tokens(b, s)
    want = np.asarray(prefill(jcfg, jparams,
                              {"tokens": jnp.asarray(tok.numpy())}))
    got = bucketed(params, {"tokens": tok})
    assert bucketed.last_bucket == key
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    bp = bucketed.specialization_table.peek(key)
    st = bucketed.last_report.stats
    assert st.device_peak <= bp.report.peak_bound_bytes <= \
        bucketed.guaranteed_peak_bytes
    assert st.arena_bytes <= bp.arena_bound_bytes
    assert bucketed.last_arena_bound == bp.arena_bound_bytes


def test_bucketed_train_step_is_bitwise_equal_to_unbucketed():
    params = init_params(SMOKE, seed=0, device="cpu")
    opt_state = init_state(params, adamw_config_for(SMOKE))
    B, S = symbolic_dims("b, s")
    batch_spec = {"tokens": TensorSpec((B, S), torch.int32),
                  "labels": TensorSpec((B, S), torch.int32)}
    fn = optimize(make_train_step(SMOKE), spec_like(params),
                  spec_like(opt_state), batch_spec,
                  dynamic_dims={"b": (1, 8), "s": (16, 256)},
                  buckets={"s": [64]}, device="cpu")
    # the whole-range plan of the same capture is the unbucketed plan
    whole = DynamicShapeFunction(fn.plan, fn.report, device=fn.device)
    for b, s in [(2, 16), (3, 200)]:
        rng = np.random.RandomState(b + s)
        batch = {k: torch.from_numpy(rng.randint(0, SMOKE.vocab, (b, s))
                                     .astype(np.int32))
                 for k in ("tokens", "labels")}
        got = pytree.tree_leaves(fn(params, opt_state, batch))
        want = pytree.tree_leaves(whole(params, opt_state, batch))
        assert fn.last_bucket is not None
        assert len(got) == len(want)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        rep = fn.specialization_table.peek(fn.last_bucket).report
        assert rep.peak_bound_bytes <= fn.guaranteed_peak_bytes
        assert fn.last_report.stats.device_peak <= rep.peak_bound_bytes


# -- the serving front end --------------------------------------------------------


def test_batcher_groups_same_bucket_requests(bucketed):
    batcher = BucketBatcher(bucketed)
    for s in [16, 40, 16, 100, 24]:
        batcher.submit({"b": 2, "s": s}, payload=s)
    assert batcher.pending() == 5
    groups = batcher.drain()
    assert batcher.pending() == 0
    by_key = {g.key: g for g in groups}
    assert sorted(by_key) == [(0, 0), (0, 1), (0, 2)]
    assert sorted(by_key[(0, 0)].payloads) == [16, 16, 24]
    assert by_key[(0, 1)].payloads == [40] and by_key[(0, 2)].payloads == [100]
    assert groups[0].key == (0, 0)           # largest group first
    assert by_key[(0, 0)].arena_bound_bytes == \
        bucketed.specialization_table.arena_bound_bytes((0, 0))


def test_batcher_admission_holds_heavy_buckets_without_recompiling(
        weights, bucketed):
    _, _, params = weights
    table = bucketed.specialization_table
    small = table.arena_bound_bytes((0, 0))
    big = table.arena_bound_bytes((0, 2))
    assert small < big
    batcher = BucketBatcher(bucketed, memory_budget=(small + big) // 2)
    batcher.submit({"b": 2, "s": 16},
                   payload=(params, {"tokens": _tokens(2, 16)}))
    batcher.submit({"b": 2, "s": 100},
                   payload=(params, {"tokens": _tokens(2, 100)}))
    (small_oc,) = batcher.process()          # the small bucket runs
    assert small_oc["ok"] and small_oc["bucket"] == (0, 0)
    assert batcher.pending_by_bucket() == {(0, 2): 1}
    spec = table.specialize_count
    for _ in range(2):                       # held, not recompiled per drain
        assert batcher.process() == []
        assert batcher.pending_by_bucket() == {(0, 2): 1}
    assert table.specialize_count == spec
    events = list(batcher.admission_events)
    assert len(events) == 3 and events[0].required_bytes == big
    assert batcher.held_count == 3 and batcher.held_by_key == {(0, 2): 3}
    batcher.memory_budget = big              # raising the budget releases it
    (oc,) = batcher.process()
    assert oc["ok"] and oc["bucket"] == (0, 2)
    assert torch.equal(oc["value"],
                       bucketed(params, {"tokens": _tokens(2, 100)}))
    assert batcher.pending() == 0


def test_batcher_first_process_runs_the_admitted_requests(weights, bucketed):
    _, _, params = weights
    batcher = BucketBatcher(bucketed)
    batcher.submit({"b": 1, "s": 20},
                   payload=(params, {"tokens": _tokens(1, 20)}))
    (oc,) = batcher.process()
    assert oc["ok"] and oc["arena_bound"] == \
        bucketed.specialization_table.arena_bound_bytes((0, 0))
    assert torch.equal(oc["value"],
                       make_prefill_step(SMOKE)(params,
                                                {"tokens": _tokens(1, 20)}))


def test_batcher_intake_rejects_and_sheds(bucketed):
    with pytest.raises(ValueError, match="outside the bucketed range"):
        BucketBatcher(bucketed).submit({"b": 2, "s": 5000})
    full = BucketBatcher(bucketed, max_queue=1)
    full.submit({"b": 2, "s": 16})
    with pytest.raises(RequestRejected) as e:
        full.submit({"b": 2, "s": 20})
    assert e.value.reason == "shed-capacity" and full.pending() == 1
    drop = BucketBatcher(bucketed, max_queue=1, shed_policy="drop-oldest")
    drop.submit({"b": 2, "s": 16}, payload="old")
    drop.submit({"b": 2, "s": 40}, payload="new")
    assert [p for _k, _e, p, _o in drop.take_shed()] == ["old"]
    clock = [0.0]
    late = BucketBatcher(bucketed, default_deadline_s=1.0,
                         clock=lambda: clock[0])
    late.submit({"b": 2, "s": 16}, payload="stale")
    clock[0] = 2.0
    assert late.drain() == [] and late.shed_by_outcome == {"shed-deadline": 1}
    with pytest.raises(ValueError, match="buckets"):
        BucketBatcher(optimize(_tiny_step,
                               TensorSpec((4, 8), torch.float32),
                               TensorSpec((8, 8), torch.float32),
                               device="cpu"))


def test_batcher_ages_out_held_groups(bucketed):
    table = bucketed.specialization_table
    big = table.arena_bound_bytes((0, 2))
    batcher = BucketBatcher(bucketed, memory_budget=big - 1,
                            max_hold_cycles=2)
    batcher.submit({"b": 2, "s": 100}, payload="heavy")
    assert batcher.drain() == [] and batcher.drain() == []
    assert batcher.drain() == [] and batcher.pending() == 0
    assert batcher.shed_by_outcome == {"shed-aged": 1}
    assert [o for *_r, o in batcher.take_shed()] == ["shed-aged"]
