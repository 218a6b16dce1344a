"""The port's rematerialization against the reference's, and under caps.

* **Bridged candidates.** On the reference's traced smoke train graph of
  each bench arch, bridged into a port ``Graph`` (``test_torch_planning``),
  the port's recompute search must find exactly the reference's
  candidates, recompute subgraphs, sources, intervals and static methods.
  The bridge carries each ``dot_general``'s contracting dims in the node
  params, the form the port's ``node_flops`` reads.
* **Caps.** The port's own smoke train step under memory limits of 0.9,
  0.75 and 0.6 of its uncapped peak: outputs bitwise equal to the
  uncapped run, ``device_peak`` <= cap, evictions, the VM and the
  ``PlanInterpreter`` bitwise equal, and every evicted tensor's storage
  really released (its views dropped with it).
* **One plan, the cap only where needed.** Under a cap set from the
  largest shape, the smallest shape runs the fast stream, evicting
  nothing.
* **Donation.** Under ``donate_inputs``, ``call_donated`` really releases
  the inputs the caller handed over, with and without a cap.
"""
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree

import repro.core.symbolic as R
import repro_torch.core.symbolic as P
from repro_torch.configs.llama2_1b import SMOKE
from repro_torch.core import (MemoryLimitExceeded, TensorSpec, optimize,
                              spec_like, symbolic_dims)
from repro_torch.core.api import DynamicShapeFunction, _compile_pipeline
from repro_torch.core.executor import memory as port_memory
from repro_torch.core.executor import vm as port_vm
from repro_torch.core.remat import build_plan
from repro_torch.core.scheduling import schedule_graph as p_schedule
from repro_torch.launch.steps import adamw_config_for, make_train_step
from repro_torch.models import init_params
from repro_torch.optim import init_state
from test_torch_bench_archs import BENCH_ARCHS
from test_torch_planning import RANGES, bridge


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, and the suite's
    workers share the cores: oversubscribed, this module ran ~9x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- bridged candidates --------------------------------------------------------


@pytest.fixture(scope="module", params=BENCH_ARCHS)
def searched(request):
    from benchmarks.memplan_bench import _step_and_specs
    from repro.core.ir import trace_to_graph
    from repro.core.remat.planner import build_plan as r_build_plan
    from repro.core.scheduling import schedule_graph as r_schedule

    step, args = _step_and_specs(request.param)
    ref_graph, _ = trace_to_graph(step, *args)
    port_graph = bridge(ref_graph)
    for rn, pn in zip(ref_graph.nodes, port_graph.nodes):
        if rn.prim_name == "dot_general":
            (lc, _rc), _ = rn.params["dimension_numbers"]
            pn.params["contracting_dims"] = (0, tuple(lc))
    sg_r, sg_p = R.ShapeGraph(), P.ShapeGraph()
    R.declare_dim_ranges(sg_r, RANGES)
    P.declare_dim_ranges(sg_p, RANGES)
    rs, ps = r_schedule(ref_graph, sg_r), p_schedule(port_graph, sg_p)
    return (r_build_plan(ref_graph, rs, sg_r),
            build_plan(port_graph, ps, sg_p, enable_remat=True))


def test_bridged_candidate_counts_equal_reference(searched):
    r, p = searched
    assert [n.id for n in r.order] == [n.id for n in p.order]
    assert (p.n_candidates, p.n_recomputable, p.n_static_regen) == \
        (r.n_candidates, r.n_recomputable, r.n_static_regen)
    assert p.n_candidates > 100 and p.n_recomputable > 10
    assert p.static_methods == r.static_methods
    assert sorted(p.candidates) == sorted(r.candidates)


def test_bridged_recompute_subgraphs_equal_reference(searched):
    r, p = searched
    for vid, rc in r.candidates.items():
        pc = p.candidates[vid]
        assert (pc.bytes_interval.lo, pc.bytes_interval.hi) == \
            (rc.bytes_interval.lo, rc.bytes_interval.hi)
        assert pc.recompute_pruned_by_bounds == rc.recompute_pruned_by_bounds
        assert (pc.recompute is None) == (rc.recompute is None)
        if rc.recompute is None:
            continue
        rp, pp = rc.recompute, pc.recompute
        assert pp.node_ids == rp.node_ids
        assert pp.source_ids == rp.source_ids
        for a, b in ((pp.impact_interval, rp.impact_interval),
                     (pp.flops_interval, rp.flops_interval)):
            assert (a.lo, a.hi) == (b.lo, b.hi)
        env = {"b": 8, "s": 512}
        assert pp.flops.evaluate(env) == rp.flops.evaluate(env)
        assert pp.impact.evaluate(env) == rp.impact.evaluate(env)


# -- the port's train step under caps --------------------------------------------

DYNAMIC_DIMS = {"b": (1, 8), "s": (16, 512)}
BIG, SMALL = (8, 512), (1, 16)
CAPS = (0.9, 0.75, 0.6)


def _batch(b, s, seed=0):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randint(0, SMOKE.vocab, (b, s))
                                .astype(np.int32))
            for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def trainer():
    params = init_params(SMOKE, seed=0, device="cpu")
    opt_state = init_state(params, adamw_config_for(SMOKE))
    B, S = symbolic_dims("b, s")
    batch = {"tokens": TensorSpec((B, S), torch.int32),
             "labels": TensorSpec((B, S), torch.int32)}
    opt = optimize(make_train_step(SMOKE), spec_like(params),
                   spec_like(opt_state), batch, dynamic_dims=DYNAMIC_DIMS,
                   device="cpu")
    args = (params, opt_state, _batch(*BIG))
    want = opt(*args)
    return opt, args, want, opt.last_report.stats.device_peak


def _equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_uncapped_plan_has_no_evict_path(trainer):
    opt, _, _, peak = trainer
    assert opt.report.n_candidates > 100
    assert opt.report.n_recomputable > 10
    assert not opt.program.has_evict_path
    assert opt.program.counts()["MaybeEvict"] == 0
    assert 0 < peak <= opt.guaranteed_peak_bytes
    # a limit the guaranteed peak already fits emits no evict path either
    assert not opt.with_memory_limit(
        opt.guaranteed_peak_bytes).program.has_evict_path


@pytest.mark.parametrize("frac", CAPS)
def test_capped_step_is_bitwise_equal_and_under_the_cap(trainer, frac):
    opt, args, want, peak = trainer
    cap = int(frac * peak)
    capped = opt.with_memory_limit(cap)
    assert capped.program.has_evict_path
    assert capped.program.counts()["MaybeEvict"] == \
        len(capped.plan.order)
    got = capped(*args)
    st = capped.last_report.stats
    assert _equal(got, want)
    assert st.device_peak <= cap
    assert st.evictions > 0 and st.evicted_bytes > 0
    # a victim is offloaded or dropped; a dropped one is recomputed when
    # read, a host copy reloaded when read or freed when its value dies
    assert st.recomputes <= st.evictions - st.offloads
    assert st.reloads <= st.offloads
    # an offload is the cost model's choice or a recompute's fallback
    assert st.recompute_fallbacks <= st.offloads
    assert st.host_used == 0 and (st.host_peak > 0) == (st.offloads > 0)
    if frac == CAPS[-1]:
        assert st.recomputes > 0 and st.offloads > 0


@pytest.mark.parametrize("frac", CAPS)
def test_vm_and_interpreter_are_bitwise_equal(trainer, frac):
    opt, args, want, peak = trainer
    cap = int(frac * peak)
    vm = opt.with_memory_limit(cap)
    ref = DynamicShapeFunction(opt.plan, opt.report, device=opt.device,
                               executor="reference").with_memory_limit(cap)
    assert ref.program is None
    got_vm, got_ref = vm(*args), ref(*args)
    assert _equal(got_vm, got_ref) and _equal(got_ref, want)
    a, b = vm.last_report.stats, ref.last_report.stats
    assert (a.device_peak, a.evictions, a.offloads, a.recomputes,
            a.recompute_fallbacks) == \
        (b.device_peak, b.evictions, b.offloads, b.recomputes,
         b.recompute_fallbacks)


def test_one_plan_caps_only_where_needed(trainer):
    opt, args, _, peak = trainer
    capped = opt.with_memory_limit(int(CAPS[-1] * peak))
    params, opt_state, _ = args
    small = _batch(*SMALL, seed=1)
    env = {"b": SMALL[0], "s": SMALL[1]}
    assert capped.program.resolve(env).fast_ok
    assert not capped.program.resolve({"b": BIG[0], "s": BIG[1]}).fast_ok
    got = capped(params, opt_state, small)
    st = capped.last_report.stats
    assert st.evictions == 0 and st.offloads == st.recomputes == 0
    assert capped.last_report.env == env
    assert _equal(got, opt(params, opt_state, small))


def test_evicted_storage_is_released(trainer, monkeypatch):
    """After each eviction no reference to the victim's storage is left —
    neither in a register, a view of it, nor an op's argument list — and
    some victim had live views that were dropped with it."""
    opt, args, want, peak = trainer
    capped = opt.with_memory_limit(int(CAPS[-1] * peak))
    prog = capped.program
    refs, offloaded = [], []
    real_offload = port_vm.offload
    real_ensure = port_memory.MemoryManager.ensure
    real_evict = port_memory.MemoryManager.evict_to_host

    def offload(t):
        refs.append(StorageWeakRef(t.untyped_storage()))
        return real_offload(t)

    def evict_to_host(self, vid):
        offloaded.append(vid)
        return real_evict(self, vid)

    def ensure(self, nbytes):
        n = len(refs)
        real_ensure(self, nbytes)
        assert all(r.expired() for r in refs[n:])

    monkeypatch.setattr(port_vm, "offload", offload)
    monkeypatch.setattr(port_memory.MemoryManager, "ensure", ensure)
    monkeypatch.setattr(port_memory.MemoryManager, "evict_to_host",
                        evict_to_host)
    assert _equal(capped(*args), want)
    assert refs and all(r.expired() for r in refs)
    assert any(prog.reg_of[vid] in prog.views_of for vid in offloaded)


def test_a_cap_below_the_floor_raises(trainer):
    opt, args, _, peak = trainer
    with pytest.raises(MemoryLimitExceeded):
        opt.with_memory_limit(peak // 10)(*args)


def test_donated_step_releases_its_inputs(trainer):
    opt, args, want, _ = trainer
    params, opt_state, batch = args
    sg = P.ShapeGraph()
    P.declare_dim_ranges(sg, DYNAMIC_DIMS)
    plan, report, _ = _compile_pipeline(opt.plan.graph, sg,
                                        donate_inputs=True)
    donated = DynamicShapeFunction(plan, report, device=opt.device,
                                   donate_inputs=True)
    # the inputs die inside the step: old weights and moments no longer
    # stand beside the new ones at the end
    assert donated.guaranteed_peak_bytes < opt.guaranteed_peak_bytes
    peak = None
    for frac in (None, CAPS[-1]):
        fn = donated if frac is None else \
            donated.with_memory_limit(int(frac * peak))
        call_args = [pytree.tree_map(torch.clone, params),
                     pytree.tree_map(torch.clone, opt_state), batch]
        refs = [StorageWeakRef(t.untyped_storage())
                for t in pytree.tree_leaves(call_args[:2])]
        got = fn.call_donated(call_args)
        assert call_args == []
        assert all(r.expired() for r in refs)
        assert _equal(got, want)
        st = fn.last_report.stats
        if frac is None:
            peak = st.device_peak
        else:
            assert st.device_peak <= int(frac * peak) and st.evictions > 0


def test_without_remat_a_cap_below_the_peak_raises_without_evicting(
        trainer):
    """``enable_remat=False`` (Table 1's ``disc-dynamic``) leaves the plan
    no remat candidates: under a limit below the peak the dynamic stream
    evicts nothing and raises ``MemoryLimitExceeded``, as the reference's
    does on the same kind of step."""
    import jax
    import jax.numpy as jnp

    import repro.core as RC
    from repro.core.executor.memory import \
        MemoryLimitExceeded as RMemoryLimitExceeded

    opt, args, _, peak = trainer
    sg = P.ShapeGraph()
    P.declare_dim_ranges(sg, DYNAMIC_DIMS)
    plan, report, _ = _compile_pipeline(opt.plan.graph, sg,
                                        enable_remat=False)
    assert plan.candidates == {} and report.n_candidates == 0
    capped = DynamicShapeFunction(plan, report, device=opt.device
                                  ).with_memory_limit(int(CAPS[0] * peak))
    assert capped.program.has_evict_path
    seen = []
    capped.interp.timeline_hook = lambda idx, inst, mm: seen.append(mm.stats)
    with pytest.raises(MemoryLimitExceeded):
        capped(*args)
    assert seen and seen[-1].evictions == seen[-1].offloads == 0

    def jstep(x, w):
        a = jnp.tanh(x @ w)
        b = jnp.tanh(a @ w)
        c = jnp.tanh(b @ w)
        return (a * c).sum() + b.sum()

    n, = RC.symbolic_dims("n")
    specs = (jax.ShapeDtypeStruct((n, 64), jnp.float32),
             jax.ShapeDtypeStruct((64, 64), jnp.float32))
    x = jnp.ones((256, 64), jnp.float32)
    w = jnp.full((64, 64), 0.01, jnp.float32)
    ref = RC.optimize(jstep, *specs, enable_remat=False)
    ref(x, w)
    assert ref.plan.candidates == {}
    with pytest.raises(RMemoryLimitExceeded):
        ref.with_memory_limit(
            int(CAPS[0] * ref.last_report.stats.device_peak))(x, w)
