"""Bounded value-dependent dims in the port, against the reference.

The same seeded numpy inputs go through the JAX package's steps and the
port's (``optimize(..., device="cpu")``):

* ``benchmarks/bounded_bench.py``'s ``ragged_ffn`` and ``filter_topk``
  at n = 192, and the ``examples/ragged_batch.py`` serve step at D = 32,
  F = 128 (bucketed), at occupancies 1.0, 0.5 and 0.  Counts and
  ``measured_dims`` must be equal; the port returns bounded outputs tight
  and the reference padded to the cap, so the port's output is held at
  2e-4 against the reference's first ``measured`` rows.  ``filter_topk``
  chains ``topk_dynamic`` after ``masked_select`` over negative values:
  the reference ranks its padding zeros too, which the port reproduces
  with the ``pad_to`` argument capture gives the chained op.
* the VM equals the interpreter bitwise, with identical stats; the
  reference's rebinding (cache-alias) and measured-zero regressions
  (``tests/test_bounded_dims.py``).  An op that mixes a bounded dim with
  a full-extent one is held in ``test_torch_capture_parity.py``.
* on the reference's traced graphs bridged into port graphs
  (``test_torch_planning.bridge``), the port's planning equals the
  reference's: schedule, remat candidates, slots, ``arena_bound_bytes``,
  instruction counts, and per occupancy ``device_peak``, ``arena_bytes``
  and ``measured_dims`` (the port's replay at the reference's measured
  extents).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.core as R
import repro_torch.core.symbolic as PS
from benchmarks.bounded_bench import ARCHS as BENCH, DIM_RANGE, N_ROWS
from repro.kernels import masked_select as j_masked_select
from repro.kernels import ref as jref
from repro_torch.core import TensorSpec, optimize, symbolic_dims
from repro_torch.core.api import _compile_pipeline
from repro_torch.core.ir.dynamism import complete_bound_env
from repro_torch.core.lowering import lower_plan
from repro_torch.kernels import (masked_select, nonzero_pad, topk_dynamic,
                                 unique_bounded)
from repro_torch.kernels import ref as pref
from test_torch_planning import bridge

OCCS = [1.0, 0.5, 0.0]
D, FF = 32, 128                     # examples/ragged_batch.py widths
BATCH_RANGE = (1, 512)
S, = symbolic_dims("s")
f32 = torch.float32


# -- the steps, in both packages -------------------------------------------------


def p_ragged_ffn(x, mask, w):
    rows, cnt = masked_select(x, mask)
    h = torch.tanh(rows @ w)
    return h.sum(0), cnt


def p_filter_topk(x, mask, k):
    y, cnt = masked_select(x, mask)
    v, kept = topk_dynamic(y * 2.0, k)
    return torch.cumsum(v, 0), cnt, kept


def j_serve_step(x, mask, w1, w2):
    rows, n_valid = j_masked_select(x, mask)
    h = jax.nn.gelu(rows @ w1)
    y = h @ w2
    return jnp.sum(y, axis=0), n_valid


def p_serve_step(x, mask, w1, w2):
    rows, n_valid = masked_select(x, mask)
    h = F.gelu(rows @ w1, approximate="tanh")   # jax.nn.gelu's default
    y = h @ w2
    return y.sum(0), n_valid


P_SPECS = {
    "ragged_ffn": (TensorSpec((S, 16), f32), TensorSpec((S,), torch.bool),
                   TensorSpec((16, 64), f32)),
    "filter_topk": (TensorSpec((S,), f32), TensorSpec((S,), torch.bool),
                    TensorSpec((), torch.int32)),
    "ragged_batch": (TensorSpec((S, D), f32), TensorSpec((S,), torch.bool),
                     TensorSpec((D, FF), f32), TensorSpec((FF, D), f32)),
}
P_STEPS = {"ragged_ffn": p_ragged_ffn, "filter_topk": p_filter_topk,
           "ragged_batch": p_serve_step}
STEPS = list(P_STEPS)


def _np_args(step, occ):
    """Seeded numpy inputs (bounded_bench's for its two archs)."""
    n = N_ROWS
    rng = np.random.RandomState(n)
    mask = np.arange(n) < int(round(n * occ))
    if step == "ragged_ffn":
        return [rng.randn(n, 16).astype(np.float32), mask,
                (rng.randn(16, 64) * 0.1).astype(np.float32)]
    if step == "filter_topk":
        return [rng.randn(n).astype(np.float32), mask, np.int32(n)]
    return [rng.randn(n, D).astype(np.float32), mask,
            (rng.randn(D, FF) * 0.05).astype(np.float32),
            (rng.randn(FF, D) * 0.05).astype(np.float32)]


def _torch(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


def _jax_fn(step):
    s = R.symbolic_dim("s")
    if step in BENCH:
        f, specs = BENCH[step]()
        return R.optimize(f, *specs, dynamic_dims={"s": DIM_RANGE})
    specs = (jax.ShapeDtypeStruct((s, D), jnp.float32),
             jax.ShapeDtypeStruct((s,), jnp.bool_),
             jax.ShapeDtypeStruct((D, FF), jnp.float32),
             jax.ShapeDtypeStruct((FF, D), jnp.float32))
    return R.optimize(j_serve_step, *specs,
                      dynamic_dims={"s": BATCH_RANGE}, buckets="geometric")


def _port_fn(step, executor="vm"):
    if step in BENCH:
        return optimize(P_STEPS[step], *P_SPECS[step],
                        dynamic_dims={"s": DIM_RANGE}, device="cpu",
                        executor=executor)
    return optimize(P_STEPS[step], *P_SPECS[step],
                    dynamic_dims={"s": BATCH_RANGE}, buckets="geometric",
                    device="cpu", executor=executor)


@pytest.fixture(scope="module")
def runs():
    """step -> occ -> (jax outputs, jax stats, port outputs, port stats,
    interpreter outputs, interpreter stats)."""
    out = {}
    for step in STEPS:
        jf, pf, pi = _jax_fn(step), _port_fn(step), \
            _port_fn(step, "reference")
        out[step] = {}
        for occ in OCCS:
            args = _np_args(step, occ)
            j = [np.asarray(o) for o in jf(*[jnp.asarray(a) for a in args])]
            p = pf(*_torch(args))
            i = pi(*_torch(args))
            out[step][occ] = (j, jf.last_report.stats, p,
                              pf.last_report.stats, i, pi.last_report.stats)
    return out


@pytest.mark.parametrize("occ", OCCS)
@pytest.mark.parametrize("step", STEPS)
def test_counts_and_valid_prefix_match_reference(runs, step, occ):
    j, jst, p, pst, _, _ = runs[step][occ]
    assert pst.measured_dims == jst.measured_dims
    assert pst.measured_dims["__b0"] == int(round(N_ROWS * occ))
    # count scalars: equal, and the measured extents they imply
    for jo, po in zip(j, p):
        if jo.ndim == 0:
            assert int(po) == int(jo)
    for jo, po in zip(j, p):
        if jo.ndim == 0:
            continue
        po = po.numpy()
        # a bounded output comes back tight: the reference's valid prefix
        assert po.shape[1:] == jo.shape[1:]
        np.testing.assert_allclose(po, jo[:po.shape[0]], rtol=2e-4,
                                   atol=2e-4)
        if step == "filter_topk":
            assert po.shape[0] == pst.measured_dims["__b1"]


def test_filter_topk_ranks_the_reference_padding():
    """At half occupancy the chained top-k sees the selected values padded
    with zeros to n, so zeros outrank the negative selected values: the
    port's prefix holds them, as the reference's does."""
    x = np.linspace(-1.0, 1.0, 8, dtype=np.float32)[::-1].copy()
    mask = np.array([1, 1, 1, 1, 0, 0, 0, 0], bool)
    mask[[4, 5]] = True          # two negative values selected
    k = np.int32(8)
    fn = optimize(p_filter_topk, *P_SPECS["filter_topk"],
                  dynamic_dims={"s": (1, 16)}, device="cpu")
    cum, _, _ = fn(*_torch([x, mask, k]))
    f, specs = BENCH["filter_topk"]()
    jfn = R.optimize(f, *specs, dynamic_dims={"s": (1, 16)})
    jcum = np.asarray(jfn(jnp.asarray(x), jnp.asarray(mask), k)[0])
    np.testing.assert_allclose(cum.numpy(), jcum[:cum.shape[0]], rtol=2e-4,
                               atol=2e-4)
    # without the padding the last two sums would fall below the fourth
    tight = np.cumsum(np.sort(x[mask] * 2.0)[::-1])
    assert not np.allclose(cum.numpy(), tight)


@pytest.mark.parametrize("step", STEPS)
def test_vm_equals_interpreter(runs, step):
    for occ in OCCS:
        _, _, p, pst, i, ist = runs[step][occ]
        for a, b in zip(p, i):
            assert torch.equal(a, b)
        d_p, d_i = pst.as_dict(), ist.as_dict()
        for key in ("last_dispatch_ns", "dispatch_ns_total"):
            d_p.pop(key), d_i.pop(key)
        assert d_p == d_i


@pytest.mark.parametrize("step", STEPS)
def test_tight_peak_below_pad_to_bound(step):
    """device_peak falls with occupancy and stays under the pad-to-bound
    peak (the program replayed with every bounded dim at its cap); the
    arena stays inside its guaranteed bound."""
    fn = _port_fn(step)
    env = {"s": N_ROWS}
    prog = fn.program
    pad = prog.stats_for(prog.resolve(
        complete_bound_env(prog.graph, env))).device_peak
    peaks = []
    for occ in (1.0, 0.75, 0.5, 0.25, 0.0):
        fn(*_torch(_np_args(step, occ)))
        st = fn.last_report.stats
        peaks.append(st.device_peak)
        assert st.arena_bytes <= fn.last_arena_bound
        if occ < 1.0:
            assert st.device_peak < pad
    assert peaks == sorted(peaks, reverse=True)
    assert peaks[0] <= pad


# -- the ops and their padded oracles ---------------------------------------------


@pytest.mark.parametrize("op", ["nonzero", "masked_select", "topk",
                                "unique"])
def test_tight_ops_are_the_padded_oracles_prefix(op):
    rng = np.random.RandomState(3)
    x = np.round(rng.randn(24), 1).astype(np.float32)
    x[rng.rand(24) < 0.3] = 0.0
    mask = rng.rand(24) < 0.4
    k = np.int32(9)
    tx, tm, tk = _torch([x, mask, k])
    if op == "nonzero":
        tight, pad, jpad = nonzero_pad(tx), pref.padded_nonzero(tx), \
            jref.reference_nonzero_pad(jnp.asarray(x))
    elif op == "masked_select":
        tight, pad, jpad = masked_select(tx, tm), \
            pref.padded_masked_select(tx, tm), \
            jref.reference_masked_select(jnp.asarray(x), jnp.asarray(mask))
    elif op == "topk":
        tight, pad, jpad = topk_dynamic(tx, tk), \
            pref.padded_topk_dynamic(tx, tk), \
            jref.reference_topk_dynamic(jnp.asarray(x), jnp.asarray(k))
    else:
        tight, pad, jpad = unique_bounded(tx), \
            pref.padded_unique_bounded(tx), \
            jref.reference_unique_bounded(jnp.asarray(x))
    # the torch oracle is the reference's
    np.testing.assert_array_equal(pad[0].numpy(), np.asarray(jpad[0]))
    assert int(pad[1]) == int(jpad[1])
    # the tight op is its valid prefix, with the same count
    assert int(tight[1]) == int(pad[1])
    assert tight[0].shape[0] == int(tight[1])
    assert torch.equal(tight[0], pad[0][:tight[0].shape[0]])


# -- rebinding, measured zero, refusal --------------------------------------------


def _select_fn(x, mask):
    y, cnt = masked_select(x * 2.0, mask)
    return y.sum(0), cnt


SELECT_SPECS = (TensorSpec((S, 4), f32), TensorSpec((S,), torch.bool))


def _mask(n, occ, seed=0):
    if occ in (0.0, 1.0):
        return torch.full((n,), occ == 1.0)
    return torch.from_numpy(np.random.RandomState(seed).rand(n) < occ)


def test_rebinding_same_env_cannot_alias_caches():
    """Two calls with identical declared dims but different measured
    bounds must not alias each other's cached resolve: each call's peak
    is tight for its own occupancy, and the cached resolve keeps the cap
    sizes throughout."""
    fn = optimize(_select_fn, *SELECT_SPECS, dynamic_dims={"s": (1, 64)},
                  device="cpu")
    n = 16
    x = torch.from_numpy(np.random.RandomState(0).randn(n, 4)
                         .astype(np.float32))
    before = fn.program.resolve({"s": n})
    cap_nbytes, cap_leaves = list(before.nbytes), list(before.leaves)
    peaks = {}
    for occ in (1.0, 0.0, 0.5):
        fn(x, _mask(n, occ))
        st = fn.last_report.stats
        peaks[occ] = st.device_peak
        assert st.measured_dims == {"__b0": int(_mask(n, occ).sum())}
    assert peaks[0.0] < peaks[0.5] < peaks[1.0], peaks
    after = fn.program.resolve({"s": n})
    assert after is before
    assert after.nbytes == cap_nbytes and after.leaves == cap_leaves


def test_rebinding_bucketed_vm_equals_interpreter():
    fn = optimize(_select_fn, *SELECT_SPECS, dynamic_dims={"s": (1, 64)},
                  buckets="geometric", device="cpu")
    ref = optimize(_select_fn, *SELECT_SPECS, dynamic_dims={"s": (1, 64)},
                   buckets="geometric", executor="reference", device="cpu")
    n = 24
    x = torch.from_numpy(np.random.RandomState(1).randn(n, 4)
                         .astype(np.float32))
    for occ in (1.0, 0.0, 1.0):
        for a, b in zip(fn(x, _mask(n, occ)), ref(x, _mask(n, occ))):
            assert torch.equal(a, b)
        sv, sr = fn.last_report.stats, ref.last_report.stats
        assert sv.measured_dims == sr.measured_dims
        assert sv.device_peak == sr.device_peak
        assert list(sv.measured_dims.values()) == [n if occ == 1.0 else 0]


def test_plan_artifacts_invariant_under_rebinding():
    fn = optimize(_select_fn, *SELECT_SPECS, dynamic_dims={"s": (1, 64)},
                  device="cpu")
    n = 12
    x = torch.from_numpy(np.random.RandomState(2).randn(n, 4)
                         .astype(np.float32))
    bound, prog = fn.report.arena_bound_bytes, fn.program
    outs = []
    for _ in range(2):
        outs.append(fn(x, _mask(n, 0.5, seed=7)))
        assert fn.report.arena_bound_bytes == bound
        assert fn.program is prog
        assert fn.last_report.stats.arena_bytes <= bound
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_measured_zero_frees_and_reuses():
    """A 0%-fill call allocates a zero-byte bounded buffer, frees it, and
    the arena slot serves the next full-occupancy call unharmed."""
    fn = optimize(_select_fn, *SELECT_SPECS, dynamic_dims={"s": (1, 64)},
                  device="cpu")
    ref = optimize(_select_fn, *SELECT_SPECS, dynamic_dims={"s": (1, 64)},
                   executor="reference", device="cpu")
    n = 10
    x = torch.from_numpy(np.random.RandomState(3).randn(n, 4)
                         .astype(np.float32))
    for occ in (0.0, 1.0, 0.0):
        o_vm, o_ref = fn(x, _mask(n, occ)), ref(x, _mask(n, occ))
        for a, b in zip(o_vm, o_ref):
            assert torch.equal(a, b)
        assert fn.last_report.stats.as_dict() == \
            ref.last_report.stats.as_dict()
        if occ == 0.0:
            assert list(fn.last_report.stats.measured_dims.values()) == [0]
            assert int(o_vm[1]) == 0
    assert fn.last_report.stats.arena_growth_bytes == 0


# -- bridged planning ------------------------------------------------------------


def _bridged_program(ref_fn):
    """The reference function's traced graph, bridged and planned by the
    port under the same ranges and caps."""
    graph = bridge(ref_fn.plan.graph)
    sg = PS.ShapeGraph()
    PS.declare_dim_ranges(sg, {"s": DIM_RANGE})
    for name, cap in graph.bound_dims.items():
        sg.declare_bound(name, cap)
    plan, report, _ = _compile_pipeline(graph, sg)
    prog = lower_plan(plan, peak_bound_bytes=report.peak_bound_bytes)
    return plan, report, prog


@pytest.mark.parametrize("step", ["ragged_ffn", "filter_topk"])
def test_bridged_bounded_planning_equals_reference(step):
    jf = _jax_fn(step)
    plan, report, prog = _bridged_program(jf)
    assert [n.id for n in plan.order] == [n.id for n in jf.plan.order]
    assert sorted(plan.candidates) == sorted(jf.plan.candidates)
    assert report.n_arena_slots == jf.report.n_arena_slots
    assert report.arena_bound_bytes == jf.report.arena_bound_bytes
    assert report.peak_bound_bytes == jf.report.peak_bound_bytes
    assert prog.counts() == jf.program.counts()
    for occ in (1.0, 0.75, 0.5, 0.25, 0.0):
        jf(*[jnp.asarray(a) for a in _np_args(step, occ)])
        jst = jf.last_report.stats
        pst = prog.stats_for(prog.resolve({"s": N_ROWS}),
                             dict(jst.measured_dims))
        assert pst.measured_dims == jst.measured_dims
        assert (pst.device_peak, pst.arena_bytes) == \
            (jst.device_peak, jst.arena_bytes)
