"""Rolled loops in the port, against the reference.

The decode cells of ``benchmarks/loop_bench.py`` for the reference's four
bench archs (``tests/test_loops.py``'s ``ARCHS``: ``llama2_1b``,
``gemma_2b`` and ``granite_8b`` take token input, ``musicgen_medium``
embedding input), at their smoke widths:
one ``scan`` with a symbolic trip count ``t``, captured once and lowered
to a single ``Loop`` instruction.  On the same seeded numpy inputs:

* the port's rolled plan is allclose (2e-4) to the JAX rolled plan at
  T in {1, 2, 17};
* rolled equals the unrolled plan (a Python loop captured at a static T)
  bitwise, and the VM equals the interpreter bitwise with identical stats
  — also under donation and under a memory limit that forces an eviction
  across the loop (``tests/test_loops.py``'s cell, whose ``big`` stays
  live across the loop);
* the program is O(body): ``Loop == 1`` and instruction counts that do
  not depend on the declared trip range; the device peak grows with T
  only by the xs and ys bytes;
* on the reference's traced graphs bridged into port graphs, the port's
  planning equals the reference's: schedule, remat candidates, slots,
  ``arena_bound_bytes``, instruction counts, and per trip count
  ``device_peak`` and ``arena_bytes``.

A scan the roll gate refuses (one opaque node) is held in
``test_torch_capture_parity.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core.symbolic as PS
from benchmarks import loop_bench as LB
from repro.configs import get_smoke_config
from repro_torch.core import (MemoryLimitExceeded, TensorSpec, optimize, scan,
                              symbolic_dims)
from repro_torch.core.api import _compile_pipeline
from repro_torch.core.lowering import lower_plan
from test_torch_planning import bridge

ARCHS = ["llama2_1b", "gemma_2b", "granite_8b", "musicgen_medium"]
TRIPS = [1, 2, 17]
T_RANGE = (1, 64)
B, V = LB.B, LB.V
f32 = torch.float32


def _cell(arch, with_big=False):
    """The port's decode cell: (step, param specs, xs spec of a length)."""
    cfg = get_smoke_config(arch)
    d = cfg.d_model
    tokens = cfg.input_mode == "tokens"

    def step(params, c, x):
        e = params["emb"][x] if tokens else x @ params["wx"]
        h = torch.tanh(c @ params["wh"] + e)
        return h, h.sum(-1)

    p = {"wh": TensorSpec((d, d), f32)}
    if with_big:
        p["wb"] = TensorSpec((d, d), f32)
    p["h0"] = TensorSpec((B, d), f32)
    if tokens:
        p["emb"] = TensorSpec((V, d), f32)
        return step, p, lambda t: TensorSpec((t, B), torch.int32)
    p["wx"] = TensorSpec((d, d), f32)
    return step, p, lambda t: TensorSpec((t, B, d), f32)


def _fn(arch, T=None, with_big=False):
    """The rolled cell (``T=None``) or its unrolled form at a static T."""
    step, _, _ = _cell(arch, with_big)

    def f(params, xs):
        c = torch.tanh(params["h0"])
        if with_big:
            # `big` is read before and after the loop: it stays live, idle,
            # across it (the eviction victim of the memory-limit test)
            big = torch.tanh(params["wb"])
            c = torch.tanh(params["h0"] + big[0])
        if T is None:
            c, ys = scan(lambda cc, x: step(params, cc, x), c, xs)
        else:
            ys = []
            for i in range(T):
                c, y = step(params, c, xs[i])
                ys.append(y)
            ys = torch.stack(ys)
        return (c @ big if with_big else c), ys
    return f


def _compile(arch, T=None, with_big=False, t_range=T_RANGE, **kw):
    _, p_specs, xs_spec = _cell(arch, with_big)
    if T is None:
        t, = symbolic_dims("t")
        return optimize(_fn(arch, None, with_big), p_specs, xs_spec(t),
                        dynamic_dims={"t": t_range}, device="cpu", **kw)
    return optimize(_fn(arch, T, with_big), p_specs, xs_spec(T),
                    device="cpu", **kw)


def _concrete(arch, T, seed, with_big=False):
    """Seeded numpy inputs: loop_bench's (plus ``wb`` for the big cell)."""
    _, p_specs, xs_spec = _cell(arch, with_big)
    rng = np.random.RandomState(seed)
    params = {k: (rng.randn(*s.shape) * 0.2).astype(np.float32)
              for k, s in p_specs.items()}
    xs = xs_spec(T)
    if xs.dtype == torch.int32:
        xv = rng.randint(0, V, xs.shape).astype(np.int32)
    else:
        xv = (rng.randn(*xs.shape) * 0.2).astype(np.float32)
    return params, xv


def _torch(params, xs):
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(xs))


def _stats(fn):
    d = fn.last_report.stats.as_dict()
    d.pop("last_dispatch_ns")
    d.pop("dispatch_ns_total")
    return d


def _assert_bitwise(a, b, msg):
    for x, y in zip(a, b):
        assert torch.equal(x, y), msg


# -- against the JAX package ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_rolled():
    out = {}
    for arch in ARCHS:
        t = R.symbolic_dim("t")
        _, p_specs, xs_spec = LB._cell(arch)
        out[arch] = R.optimize(LB._rolled_fn(arch), p_specs, xs_spec(t),
                               dynamic_dims={"t": LB.NARROW})
    return out


@pytest.mark.parametrize("T", TRIPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_rolled_matches_jax(jax_rolled, arch, T):
    fn = _compile(arch)
    params, xs = _concrete(arch, T, seed=T)
    j_c, j_ys = jax_rolled[arch]({k: jnp.asarray(v) for k, v in
                                  params.items()}, jnp.asarray(xs))
    p_c, p_ys = fn(*_torch(params, xs))
    np.testing.assert_allclose(p_c.numpy(), np.asarray(j_c), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(p_ys.numpy(), np.asarray(j_ys), rtol=2e-4,
                               atol=2e-4)
    assert fn.program.counts()["Loop"] == 1


# -- rolled vs unrolled, VM vs interpreter ------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_bitwise_outputs_and_identical_stats(arch):
    ref = _compile(arch, with_big=True, executor="reference")
    vm = _compile(arch, with_big=True)
    for T in TRIPS:
        params, xs = _concrete(arch, T, seed=T, with_big=True)
        r_out = ref(*_torch(params, xs))
        v_out = vm(*_torch(params, xs))
        _assert_bitwise(r_out, v_out, f"{arch} T={T}: VM != interpreter")
        assert _stats(ref) == _stats(vm)
        oracle = _compile(arch, T, with_big=True)
        _assert_bitwise(r_out, oracle(*_torch(params, xs)),
                        f"{arch} T={T}: rolled != unrolled")


@pytest.mark.parametrize("arch", ARCHS)
def test_donate_inputs_differential(arch):
    ref = _compile(arch, with_big=True, executor="reference",
                   donate_inputs=True)
    vm = _compile(arch, with_big=True, donate_inputs=True)
    base = _compile(arch, with_big=True)
    for T in (2, 17):
        params, xs = _concrete(arch, T, seed=T, with_big=True)
        b_out = base(*_torch(params, xs))
        r_out = ref.call_donated(list(_torch(params, xs)))
        v_out = vm.call_donated(list(_torch(params, xs)))
        _assert_bitwise(r_out, v_out, f"{arch} T={T} donate: VM != ref")
        _assert_bitwise(r_out, b_out, f"{arch} T={T}: donation changed it")
        assert _stats(ref) == _stats(vm)


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_limit_regen_differential(arch):
    free = _compile(arch, with_big=True)
    params, xs = _concrete(arch, 17, seed=17, with_big=True)
    base_out = free(*_torch(params, xs))
    # tight enough that `big` (idle across the loop) must be evicted
    # before the Loop's hoisted ensure, loose enough to succeed
    limit = free.last_report.stats.device_peak - 512
    ref = _compile(arch, with_big=True, executor="reference",
                   memory_limit=limit)
    vm = _compile(arch, with_big=True, memory_limit=limit)
    r_out = ref(*_torch(params, xs))
    v_out = vm(*_torch(params, xs))
    _assert_bitwise(r_out, v_out, f"{arch} limited: VM != interpreter")
    _assert_bitwise(r_out, base_out, f"{arch}: eviction changed outputs")
    r_stats = _stats(ref)
    assert r_stats == _stats(vm)
    assert r_stats["evictions"] >= 1
    assert r_stats["recomputes"] + r_stats["reloads"] >= 1
    assert r_stats["device_peak"] <= limit


@pytest.mark.parametrize("arch", ARCHS)
def test_impossible_limit_raises_on_both(arch):
    params, xs = _concrete(arch, 17, seed=17, with_big=True)
    limit = sum(v.nbytes for v in params.values())
    for executor in ("reference", "vm"):
        fn = _compile(arch, with_big=True, executor=executor,
                      memory_limit=limit)
        with pytest.raises(MemoryLimitExceeded):
            fn(*_torch(params, xs))


# -- plan size and steady-state memory --------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_program_is_o_body_not_o_trip(arch):
    counts = _compile(arch).program.counts()
    assert counts["Loop"] == 1
    assert _compile(arch, t_range=(1, 4096)).program.counts() == counts
    unrolled = _compile(arch, 17).program.counts()
    assert unrolled["Compute"] > 17 * max(1, counts["Compute"])
    assert sum(counts.values()) < sum(unrolled.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_steady_state_peak_independent_of_trip(arch):
    fn = _compile(arch)
    peaks = {}
    for T in (2, 17, 33):
        fn(*_torch(*_concrete(arch, T, seed=1)))
        peaks[T] = fn.last_report.stats.device_peak
        assert fn.last_report.stats.arena_bytes <= fn.arena_bound_bytes
    _, _, xs_spec = _cell(arch)
    x1 = xs_spec(1)
    step = int(np.prod(x1.shape)) * x1.dtype.itemsize + B * 4
    assert peaks[17] - peaks[2] == 15 * step
    assert peaks[33] - peaks[17] == 16 * step


def test_scan_outside_optimize_is_a_python_loop():
    wh = torch.randn(8, 8)
    h0, xs = torch.randn(2, 8), torch.randn(5, 2, 8)

    def body(h, x):
        h = torch.tanh(h @ wh + x)
        return h, h.sum(-1)

    c, ys = scan(body, h0, xs)
    h, want = h0, []
    for i in range(5):
        h, y = body(h, xs[i])
        want.append(y)
    assert torch.equal(c, h) and torch.equal(ys, torch.stack(want))


# -- bridged planning ------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_bridged_loop_planning_equals_reference(jax_rolled, arch):
    jf = jax_rolled[arch]
    graph = bridge(jf.plan.graph)
    sg = PS.ShapeGraph()
    PS.declare_dim_ranges(sg, {"t": LB.NARROW})
    plan, report, _ = _compile_pipeline(graph, sg)
    prog = lower_plan(plan, peak_bound_bytes=report.peak_bound_bytes)
    assert [n.id for n in plan.order] == [n.id for n in jf.plan.order]
    assert sorted(plan.candidates) == sorted(jf.plan.candidates)
    assert report.n_arena_slots == jf.report.n_arena_slots
    assert report.arena_bound_bytes == jf.report.arena_bound_bytes
    assert report.peak_bound_bytes == jf.report.peak_bound_bytes
    assert prog.counts() == jf.program.counts()
    for T in TRIPS:
        params, xs = _concrete(arch, T, seed=T)
        jf({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(xs))
        jst = jf.last_report.stats
        pst = prog.stats_for(prog.resolve({"t": T}))
        assert (pst.device_peak, pst.arena_bytes, pst.reuse_ratio) == \
            (jst.device_peak, jst.arena_bytes, jst.reuse_ratio)
