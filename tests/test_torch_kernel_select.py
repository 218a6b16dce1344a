"""Per-bucket kernel-variant selection on the Hopper cost model.

Mirrors ``tests/test_kernel_select.py`` for the port's routes (the sm90
bf16 and f32 FMA flash kernels, the RMSNorm kernel, and each op's plain
version):

* **validity** — shrinking the per-block shared memory only ever shrinks
  the valid set; over hypothesis-drawn ranges (unbounded corners
  included) the selected variant is valid at the range's hi corner, f32
  never gets the sm90 kernel and bf16 never the FMA route; the plain
  attention's hidden f32 scores rule it out wherever they could exceed
  ``max_transient_bytes``;
* **wiring** — the selected name lands in the lowered Program's argument
  templates (and the interpreter's) while ``node.params`` stay as
  captured; the VM and the interpreter agree bitwise in every bucket;
  the memory plan is identical whatever the variants;
* **plain plans** — ``kernel_select=False`` keeps a plain step's
  ``impl="ref"``: it launches no kernel, where selection would override it;
* **the ops** — a variant name runs the plain version on a CPU tensor,
  and a name whose kernel does not take the dtype raises;
* **measured fallback** — ``remeasure_kernels`` swaps only its bucket,
  never to a variant invalid over the bucket, records the timings, and
  ``kernel_remeasure_after`` fires once per bucket.
"""
import copy

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import TensorSpec, optimize, symbolic_dims
from repro_torch.core.api import _compile_pipeline
from repro_torch.kernels import flash_attention, ops, rmsnorm
from repro_torch.kernels import variants as V
from repro_torch.kernels.hw_model import DEFAULT_HW
from repro_torch.kernels.ref import reference_attention, reference_rmsnorm

# a kernel_bench-like step (one node per kernel) small enough for the CPU
HQ, HKV, HD, D = 2, 1, 32, 64
B_RANGE, S_RANGE, EDGES = (1, 4), (1, 512), [64]
SMALL_ENV, LARGE_ENV = (2, 16), (1, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fwd(impl=None):
    def fwd(q, k, v, x, scale):
        return flash_attention(q, k, v, True, None, impl), \
            rmsnorm(x, scale, 1e-6, impl)
    return fwd


def _specs(dtype=torch.float32):
    B, S = symbolic_dims("b, s")
    return (TensorSpec((B, HQ, S, HD), dtype),
            TensorSpec((B, HKV, S, HD), dtype),
            TensorSpec((B, HKV, S, HD), dtype),
            TensorSpec((B, S, D), dtype), TensorSpec((D,), dtype))


def _args(b, s, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def f(*sh):
        return torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)
                                ).to(dtype)
    return (f(b, HQ, s, HD), f(b, HKV, s, HD), f(b, HKV, s, HD),
            f(b, s, D), f(D))


def _compile(executor="vm", impl=None, dtype=torch.float32, **kw):
    kw.setdefault("buckets", {"s": EDGES})
    return optimize(_fwd(impl), *_specs(dtype),
                    dynamic_dims={"b": B_RANGE, "s": S_RANGE},
                    executor=executor, device="cpu", **kw)


def _stats(fn):
    d = fn.last_report.stats.as_dict()
    for k in ("last_dispatch_ns", "dispatch_ns_total", "bucket_hits",
              "specialize_count"):
        d.pop(k)
    return d


def _bucket_plan(fn, b, s):
    table = fn.specialization_table
    return table.peek(table.key_of({"b": b, "s": s})).plan


def _names(plan):
    return {s.prim_name: s.variant.name
            for s in plan.kernel_selections.values()}


# -- the hardware model and the variant table -------------------------------------

def test_default_hw_is_the_published_h100():
    hw = DEFAULT_HW
    assert (hw.sm_count, hw.smem_per_block_optin, hw.smem_per_sm,
            hw.regs_per_sm) == (132, 232448, 233472, 65536)
    assert (hw.hbm_bw, hw.tensor_flops, hw.fp32_flops) == \
        (3.35e12, 989e12, 67e12)
    # the allocator check's grant for one live tensor over 1 MiB
    assert hw.max_transient_bytes == (1 << 20) + 512
    assert hw.with_smem(1024).smem_per_block_optin == 1024


def test_shared_memory_of_the_kernels_matches_their_sources():
    sm = {hd: V.variant_smem_bytes("flash_attention", V.SM90, {"hd": hd})
          for hd in V.HEAD_DIMS}
    # Geo<HD>::SMEM: the Q tile, 4 K/V tiles of BN rows + barriers + 1 KB,
    # at least 116 KB; hd 256 takes 64-key tiles, as 128-key ones would
    # not fit
    assert sm == {32: 116 * 1024, 64: 116 * 1024, 128: 5 * 32768 + 1088,
                  256: 65536 + 4 * 32768 + 1088}
    assert [V.variant_block(V.SM90, {"hd": hd})["block_kv"]
            for hd in V.HEAD_DIMS] == [128, 128, 128, 64]
    assert 5 * 128 * 256 * 2 > DEFAULT_HW.smem_per_block_optin
    # Geo<HD, Elem>::SMEM of the mma kernel: the 64-row Q tile and 2
    # stages of K and V tiles of BN rows (f32: 32 at hd 128 and 256; bf16:
    # 16 at 256), every row HD and a 16-byte pad
    mma = {hd: V.variant_smem_bytes("flash_attention", V.MMA_F32, {"hd": hd})
           for hd in V.MMA_HEAD_DIMS}
    assert mma == {16: 320 * 20 * 4, 32: 320 * 36 * 4, 48: 320 * 52 * 4,
                   64: 320 * 68 * 4, 128: 192 * 132 * 4, 256: 192 * 260 * 4}
    assert [V.variant_block(V.MMA_F32, {"hd": hd})["block_kv"]
            for hd in V.MMA_HEAD_DIMS] == [64, 64, 64, 64, 32, 32]
    assert [V.variant_block(V.MMA_BF16, {"hd": hd})["block_kv"]
            for hd in (12, 48, 100, 200)] == [64, 64, 64, 16]
    assert max(mma.values()) <= DEFAULT_HW.smem_per_block_optin
    assert V.variant_smem_bytes("flash_attention", V.REF_DENSE,
                                {"hd": None}) == 0
    assert max(sm.values()) <= DEFAULT_HW.smem_per_block_optin


def test_the_mma_variants_are_priced_on_the_tensor_cores():
    """The f32 mma variant runs each product as three TF32 products: its
    compute time is the products over ``tf32_flops / 3`` (the softmax on
    the f32 units).  The bf16 one never outranks the sm90 kernel at a
    head dim that kernel takes: the route rule makes it invalid there."""
    from dataclasses import replace
    # HBM taken out of the roofline, so that the compute term shows alone
    hw = replace(DEFAULT_HW, hbm_bw=1e30)
    shape = {"b": 8, "hq": 32, "hkv": 32, "s": 1024, "t": 1024, "hd": 128}
    raw = V.flash_cost(V.MMA_F32, shape, torch.float32, {"causal": True},
                       hw, 1.0)
    block = V.variant_block(V.MMA_F32, shape)
    bq, bkv = block["block_q"], block["block_kv"]
    pairs = V._causal_block_pairs(1024 // bq, 1024 // bkv, bq, bkv)
    products = 8 * 32 * pairs * 4.0 * bq * bkv * 128
    softmax = 8 * 32 * pairs * 8.0 * bq * bkv
    compute = products / (hw.tf32_flops / 3) + softmax / hw.fp32_flops
    assert raw.flops == products + softmax
    smem = V.variant_smem_bytes("flash_attention", V.MMA_F32, shape)
    fill = V._fill(8 * 32 * (1024 // bq), V.MMA_F32, smem, hw)
    assert raw.time_s == pytest.approx(compute / fill + hw.launch_s)
    # a faster TF32 unit speeds the f32 variant and not the bf16 one
    fast = replace(hw, tf32_flops=2 * hw.tf32_flops)
    assert V.flash_cost(V.MMA_F32, shape, torch.float32, {"causal": True},
                        fast, 1.0).time_s < raw.time_s
    small = dict(shape, hq=4, hkv=2, hd=16)
    assert V.flash_cost(V.MMA_BF16, small, torch.bfloat16, {"causal": True},
                        fast, 1.0) == V.flash_cost(
        V.MMA_BF16, small, torch.bfloat16, {"causal": True}, hw, 1.0)
    for hd in V.HEAD_DIMS:
        bounds = {"b": (1, 8), "hq": (32, 32), "hkv": (8, 8),
                  "s": (16, 1024), "t": (16, 1024), "hd": (hd, hd)}
        got, scores, _p, invalid = V.select_variant(
            "flash_attention", bounds, torch.bfloat16, {"causal": True})
        assert got is V.SM90 and V.MMA_BF16.name not in scores
        assert "takes the sm90 kernel" in invalid[V.MMA_BF16.name]


def test_the_model_reproduces_its_calibration_rows():
    for name, (shape, dtype, measured) in V.CALIBRATION.items():
        prim = "flash_attention" if "hd" in shape else "rmsnorm"
        variant = next(v for v in V.variants_for(prim) if v.name == name)
        got = V.variant_cost(prim, variant, shape, dtype, {"causal": True},
                             DEFAULT_HW).time_s
        assert got == pytest.approx(measured, rel=1e-9)
        assert 0 < V.efficiency(prim, variant) <= 1.5


def test_helpers_equal_the_reference():
    from repro.kernels import variants as RV
    for nq, nk, bq, bkv in [(8, 8, 128, 128), (16, 32, 64, 32), (3, 5, 64, 32),
                            (1, 1, 128, 128)]:
        assert V._causal_block_pairs(nq, nk, bq, bkv) == \
            RV._causal_block_pairs(nq, nk, bq, bkv)
    bounds = {"b": (1, 8), "s": (16, 1024), "hd": (128, 128),
              "t": (3, None)}
    assert V._probe_shapes(bounds) == RV._probe_shapes(bounds)


@pytest.mark.parametrize("prim", ["flash_attention", "rmsnorm"])
def test_valid_set_shrinks_with_shared_memory(prim):
    """A smaller per-block limit can only remove variants; the plain
    version (no shared memory) survives every limit where its transients
    fit."""
    hi = ({"b": 1, "hq": 2, "hkv": 2, "s": 16, "t": 16, "hd": 128}
          if prim == "flash_attention" else {"n": 16, "d": 1024})
    prev = None
    for smem in (DEFAULT_HW.smem_per_block_optin, 120 * 1024, 64 * 1024,
                 32 * 1024, 1024, 0):
        hw = DEFAULT_HW.with_smem(smem)
        valid = set()
        for dtype in (torch.float32, torch.bfloat16):
            valid |= {(v.name, dtype) for v in V.variants_for(prim)
                      if V.variant_valid(prim, v, hi, dtype, hw)}
        assert {n for n, _ in valid} >= {v.name for v in V.variants_for(prim)
                                         if v.route == "ref"}
        if prev is not None:
            assert valid <= prev, (smem, valid - prev)
        prev = valid


def test_the_plain_attention_transients_rule_it_out_at_full_width():
    big = {"b": 8, "hq": 32, "hkv": 32, "s": 1024, "t": 1024, "hd": 128}
    # two b·hq·s·t f32 score matrices (2 GiB) and the f32 copies
    tb = V.variant_transient_bytes("flash_attention", V.REF_DENSE, big, 2)
    assert tb > 2 * 4 * 8 * 32 * 1024 * 1024
    why = V.variant_invalid_reason("flash_attention", V.REF_DENSE, big,
                                   torch.bfloat16)
    assert "max_transient_bytes" in why
    tiny = {"b": 1, "hq": 2, "hkv": 1, "s": 16, "t": 16, "hd": 32}
    assert V.variant_valid("flash_attention", V.REF_DENSE, tiny,
                           torch.float32)
    unbounded = dict(tiny, s=None, t=None)
    assert not V.variant_valid("flash_attention", V.REF_DENSE, unbounded,
                               torch.float32)
    # the kernels allocate nothing the plan does not count
    assert V.variant_transient_bytes("flash_attention", V.SM90, big, 2) == 0


@pytest.mark.parametrize("bounds,want", [
    # llama2_1b's whole range: the kernels
    ({"b": (1, 8), "s": (16, 1024)}, ("sm90_bm128_bn128", "cuda_reg_rows")),
    # its smallest geometric bucket: the plain versions' transients still
    # exceed the limit at the bucket's hi corner
    ({"b": (1, 2), "s": (16, 45)}, ("sm90_bm128_bn128", "cuda_reg_rows")),
])
def test_llama2_1b_ranges_select_the_kernels(bounds, want):
    b, s = bounds["b"], bounds["s"]
    fa = {"b": b, "hq": (32, 32), "hkv": (32, 32), "s": s, "t": s,
          "hd": (128, 128)}
    rn = {"n": (b[0] * s[0], b[1] * s[1]), "d": (4096, 4096)}
    got_fa, _, _, inv_fa = V.select_variant("flash_attention", fa,
                                            torch.bfloat16, {"causal": True})
    got_rn, _, _, inv_rn = V.select_variant("rmsnorm", rn, torch.bfloat16, {})
    assert (got_fa.name, got_rn.name) == want
    assert "max_transient_bytes" in inv_fa["ref_dense"]
    assert "max_transient_bytes" in inv_rn["ref_unfused"]


def _rand_bounds(prim, rng):
    def one(lo_hi, unbounded_ok=True):
        lo = int(rng.integers(1, lo_hi))
        if unbounded_ok and rng.random() < 0.25:
            return (lo, None)
        return (lo, lo + int(rng.integers(0, 4096)))
    if prim == "flash_attention":
        hd = int(rng.choice([16, 32, 64, 128, 256]))
        hkv = int(rng.integers(1, 8))
        return {"b": one(8), "hq": (hkv * 2, hkv * 2), "hkv": (hkv, hkv),
                "s": one(64), "t": one(64), "hd": (hd, hd)}
    return {"n": one(64), "d": one(4096)}


@settings(max_examples=60, deadline=None)
@given(prim=st.sampled_from(["flash_attention", "rmsnorm"]),
       dtype=st.sampled_from([torch.float32, torch.bfloat16]),
       smem=st.sampled_from([DEFAULT_HW.smem_per_block_optin, 100 * 1024,
                             32 * 1024]),
       seed=st.integers(0, 10**6))
def test_no_selected_variant_is_invalid_at_the_hi_corner(prim, dtype, smem,
                                                         seed):
    hw = DEFAULT_HW.with_smem(smem)
    bounds = _rand_bounds(prim, np.random.default_rng(seed))
    hi = {k: h for k, (_lo, h) in bounds.items()}
    try:
        variant, scores, _probes, invalid = V.select_variant(
            prim, bounds, dtype, {"causal": True}, hw)
    except ValueError:
        # nothing can serve the range: every variant is invalid
        assert not any(V.variant_valid(prim, v, hi, dtype, hw)
                       for v in V.variants_for(prim))
        return
    assert V.variant_valid(prim, variant, hi, dtype, hw)
    assert variant.name in scores
    for name in invalid:
        bad = next(v for v in V.variants_for(prim) if v.name == name)
        assert not V.variant_valid(prim, bad, hi, dtype, hw)
        assert name not in scores
    # f32 never gets the sm90 kernel, bf16 the mma route only at a head
    # dim the sm90 kernel has no instance for (the op's route rule)
    assert not (dtype == torch.float32 and variant.route == "sm90")
    assert not (dtype == torch.bfloat16 and variant.route == "mma"
                and hi["hd"] in V.HEAD_DIMS)
    if dtype == torch.bfloat16 and variant.route == "mma":
        assert variant is V.MMA_BF16


def test_a_forced_invalid_variant_raises():
    bounds = {"b": (1, 8), "hq": (32, 32), "hkv": (32, 32), "s": (16, 1024),
              "t": (16, 1024), "hd": (128, 128)}
    for dtype, forced in ((torch.bfloat16, "ref_dense"),
                          (torch.float32, "sm90_bm128_bn128"),
                          (torch.bfloat16, "mma_f32_bq64_bkv64")):
        with pytest.raises(ValueError, match="not valid"):
            V.select_variant("flash_attention", bounds, dtype,
                             {"causal": True}, forced=forced)
    fn = _compile(buckets=None)
    nid = next(n for n, s in fn.plan.kernel_selections.items()
               if s.prim_name == "flash_attention")
    with pytest.raises(ValueError, match="not valid"):
        _compile_pipeline(fn.plan.graph, fn.plan.shape_graph,
                          kernel_forced={nid: "sm90_bm128_bn128"})


def test_select_eager_picks_the_kernel_of_the_dtype():
    shape = {"b": 2, "hq": 4, "hkv": 2, "s": 256, "t": 256, "hd": 64}
    assert V.select_eager("flash_attention", shape, torch.bfloat16,
                          {"causal": True}).name == "sm90_bm128_bn128"
    assert V.select_eager("flash_attention", shape, torch.float32,
                          {"causal": True}).name == "mma_f32_bq64_bkv64"
    # no kernel takes float64: only the plain version, where it fits
    small = dict(shape, s=8, t=8)
    assert V.select_eager("flash_attention", small, torch.float64,
                          {"causal": True}).name == "ref_dense"
    with pytest.raises(ValueError, match="no valid"):
        V.select_eager("flash_attention", shape, torch.float64,
                       {"causal": True})


# -- the ops ---------------------------------------------------------------------

def test_variant_names_run_the_plain_version_on_the_cpu():
    q, k, v, x, scale = _args(2, 40)
    want = reference_attention(q, k, v)
    for impl in ("mma_f32_bq64_bkv64", "ref_dense", "ref", None):
        assert torch.equal(flash_attention(q, k, v, True, None, impl), want)
    for impl in ("cuda_reg_rows", "ref_unfused", "ref", None):
        assert torch.equal(rmsnorm(x, scale, 1e-6, impl),
                           reference_rmsnorm(x, scale))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    assert torch.equal(
        flash_attention(qb, kb, vb, True, None, "sm90_bm128_bn128"),
        flash_attention(qb, kb, vb, True, None, "ref"))


def test_a_name_whose_kernel_does_not_take_the_dtype_raises():
    q, k, v, x, scale = _args(1, 16)
    with pytest.raises(ValueError, match="takes torch.bfloat16"):
        flash_attention(q, k, v, True, None, "sm90_bm128_bn128")
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    with pytest.raises(ValueError, match="takes torch.float32"):
        flash_attention(qb, kb, vb, True, None, "mma_f32_bq64_bkv64")
    for bad in ("cuda_reg_rows", "pallas_128x128"):
        with pytest.raises(ValueError, match="impl must be one of"):
            flash_attention(q, k, v, True, None, bad)
    with pytest.raises(ValueError, match="impl must be one of"):
        rmsnorm(x, scale, 1e-6, "sm90_bm128_bn128")


# -- wiring: overrides, executors, memory -----------------------------------------

def test_overrides_land_in_the_program_and_leave_node_params_alone():
    fn = _compile()
    graph = fn.plan.graph
    before = {n.id: copy.copy(n.params["leaves"]) for n in graph.nodes}
    for b, s in (SMALL_ENV, LARGE_ENV):
        fn(*_args(b, s))
    plans = [fn.plan] + [fn.specialization_table.peek(k).plan
                         for k in fn.specialization_table.compiled_keys]
    programs = [fn.program] + [fn.specialization_table.peek(k).program
                               for k in fn.specialization_table.compiled_keys]
    for plan, program in zip(plans, programs):
        for comp in program.computes:
            sel = plan.kernel_selections.get(comp.node.id)
            if sel is None:
                assert list(comp.template) == comp.node.params["leaves"]
                continue
            assert sel.variant.name in comp.template
    assert {n.id: n.params["leaves"] for n in graph.nodes} == before
    names = {v.name for prim in V.registered_kernels()
             for v in V.variants_for(prim)}
    assert not any(x in names for leaves in before.values() for x in leaves
                   if isinstance(x, str))


def test_selection_per_bucket_follows_the_dtype():
    for dtype, want in ((torch.float32, "mma_f32_bq64_bkv64"),
                        (torch.bfloat16, "sm90_bm128_bn128")):
        fn = _compile(dtype=dtype)
        for b, s in (SMALL_ENV, LARGE_ENV):
            fn(*_args(b, s, dtype=dtype))
            names = _names(_bucket_plan(fn, b, s))
            assert names == {"flash_attention": want,
                             "rmsnorm": "cuda_reg_rows"}
        assert _names(fn.plan) == names
        sel = next(iter(fn.plan.kernel_selections.values()))
        assert sel.is_default and sel.model_speedup >= 1.0


def test_vm_matches_interpreter_bitwise_per_bucket():
    fn_vm, fn_ref = _compile("vm"), _compile("reference")
    for b, s in (SMALL_ENV, LARGE_ENV):
        args = _args(b, s, seed=b + s)
        out_vm, out_ref = fn_vm(*args), fn_ref(*args)
        assert fn_vm.last_bucket == fn_ref.last_bucket
        for x, y in zip(out_vm, out_ref):
            assert torch.equal(x, y), (b, s)
        assert _stats(fn_vm) == _stats(fn_ref), (b, s)


def test_memory_stats_identical_across_variants():
    """Variant choice changes kernel arguments only — the memory plan, the
    arena and the guaranteed bounds are byte-identical."""
    fns = [_compile(impl=None, kernel_select=True),
           _compile(impl=None, kernel_select=False),
           _compile(impl="ref", kernel_select=False)]
    assert len({fn.guaranteed_peak_bytes for fn in fns}) == 1
    assert len({fn.arena_bound_bytes for fn in fns}) == 1
    for b, s in (SMALL_ENV, LARGE_ENV):
        stats = []
        for fn in fns:
            fn(*_args(b, s))
            stats.append(_stats(fn))
        assert stats[0] == stats[1] == stats[2], (b, s)


@pytest.fixture
def counted_kernels(monkeypatch):
    """The kernel wrappers replaced by their plain versions with launch
    counters, and a CPU tensor routed to them as a CUDA tensor would be."""
    launches = {"flash": 0, "rmsnorm": 0}
    real_route = ops._route

    def route(impl, x, impls):
        r = real_route(impl, x, impls)
        named = impl is not None and not impl.startswith("ref")
        return "cuda" if r == "ref" and named else r

    def flash(q, k, v, *, causal=True, softmax_scale=None):
        launches["flash"] += 1
        return torch.empty_like(q).copy_(reference_attention(
            q, k, v, causal=causal, softmax_scale=softmax_scale))

    def norm(x, scale, *, eps=1e-6):
        launches["rmsnorm"] += 1
        return reference_rmsnorm(x, scale, eps)

    monkeypatch.setattr(ops, "_route", route)
    monkeypatch.setattr(ops, "flash_attention_cuda", flash)
    monkeypatch.setattr(ops, "rmsnorm_cuda", norm)
    return launches


def test_a_plain_plan_launches_no_kernel(counted_kernels):
    """``kernel_select=False`` keeps ``impl="ref"``; with selection on,
    the same plain step would launch the kernels (selection overrides a
    call-site impl, as the reference's does)."""
    plain = _compile(impl="ref", kernel_select=False)
    selected = _compile(impl="ref")
    for b, s in (SMALL_ENV, LARGE_ENV):
        args = _args(b, s)
        n0 = dict(counted_kernels)
        want = plain(*args)
        assert counted_kernels == n0
        got = selected(*args)
        assert counted_kernels == {"flash": n0["flash"] + 1,
                                   "rmsnorm": n0["rmsnorm"] + 1}
        for x, y in zip(got, want):
            assert torch.equal(x, y)


# -- measured fallback ------------------------------------------------------------

def test_remeasure_swaps_the_monolithic_plan():
    fn = _compile(buckets=None)
    args = _args(1, 32)
    want = fn(*args)
    forced = fn.remeasure_kernels(repeats=1)
    sels = fn.plan.kernel_selections
    assert set(forced) == set(sels)
    assert all(s.measured and s.measured_s for s in sels.values())
    for nid, sel in sels.items():
        assert sel.variant.name == forced[nid]
        assert set(sel.measured_s) <= {v.name
                                       for v in V.variants_for(sel.prim_name)}
    for got, w in zip(fn(*args), want):
        torch.testing.assert_close(got, w)


def test_remeasure_recompiles_only_its_bucket():
    fn = _compile()
    fn(*_args(*LARGE_ENV))
    large = _bucket_plan(fn, *LARGE_ENV)
    args = _args(*SMALL_ENV)
    want = fn(*args)
    forced = fn.remeasure_kernels(repeats=1)
    small = _bucket_plan(fn, *SMALL_ENV)
    assert all(s.measured for s in small.kernel_selections.values())
    # the whole-range plan and the other bucket keep the model's choice
    assert not any(s.measured for s in fn.plan.kernel_selections.values())
    assert _bucket_plan(fn, *LARGE_ENV) is large
    # every forced winner is valid at the bucket's upper corner
    table = fn.specialization_table
    sg = fn.plan.shape_graph.specialized(table.space.ranges_of(
        table.key_of({"b": SMALL_ENV[0], "s": SMALL_ENV[1]})))
    for nid, name in forced.items():
        node = fn.plan.node_by_id[nid]
        hi = {k: h for k, (_lo, h) in V.node_bounds(node, sg).items()}
        variant = next(v for v in V.variants_for(V.kernel_key(node))
                       if v.name == name)
        assert V.variant_valid(V.kernel_key(node), variant, hi,
                               node.invals[0].dtype)
    for got, w in zip(fn(*args), want):
        torch.testing.assert_close(got, w)


def test_kernel_remeasure_after_fires_once_per_bucket(monkeypatch):
    calls = []
    real = V.measure_variants

    def counted(*a, **kw):
        calls.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(V, "measure_variants", counted)
    fn = _compile(kernel_remeasure_after=2)
    args = _args(*SMALL_ENV)
    fn(*args)
    assert not calls and not any(
        s.measured for s in _bucket_plan(fn, *SMALL_ENV)
        .kernel_selections.values())
    fn(*args)
    fn.drain_specializations()
    assert sorted(calls) == ["flash_attention", "rmsnorm"]
    assert all(s.measured for s in _bucket_plan(fn, *SMALL_ENV)
               .kernel_selections.values())
    for _ in range(3):
        fn(*args)
    fn.drain_specializations()
    assert len(calls) == 2                   # once per bucket, not per call
    fn(*_args(*LARGE_ENV))
    fn(*_args(*LARGE_ENV))
    assert len(calls) == 4                   # the other bucket's turn


def test_measure_variants_times_the_valid_variants_on_the_cpu():
    fn = _compile(buckets=None)
    env = {"b": 1, "s": 16}
    for nid, sel in fn.plan.kernel_selections.items():
        node = fn.plan.node_by_id[nid]
        timed = V.measure_variants(sel.prim_name, node, env, repeats=1,
                                   device="cpu")
        shape = V.node_shape(node, env)
        valid = {v.name for v in V.variants_for(sel.prim_name)
                 if V.variant_valid(sel.prim_name, v, shape, torch.float32)}
        assert set(timed) == valid and all(t > 0 for t in timed.values())
