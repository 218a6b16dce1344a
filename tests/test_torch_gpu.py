"""The port's CUDA kernels and serving path on a card (``-m gpu``).

Every test here needs a CUDA device and skips without one; the file
imports neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.kernels import (flash_attention, flash_attention_cuda,
                                 reference_attention, reference_rmsnorm,
                                 rmsnorm, rmsnorm_cuda)
from repro_torch.kernels.flash_attention import route_of

# bf16: one rounding of the output is 2^-8 relative; kernel and plain
# version may round one ulp apart, which 1e-2 covers and a lost kv tile
# does not
TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
FLASH_SHAPES = [  # (b, hq, hkv, s, t, hd): tests/test_kernels.py + S != T
    (2, 4, 2, 256, 256, 64), (1, 8, 1, 128, 128, 128),
    (2, 4, 4, 100, 100, 64), (1, 6, 2, 384, 384, 32),
    (3, 2, 1, 64, 64, 64), (1, 4, 2, 100, 160, 64),
    (1, 32, 32, 1024, 1024, 128),  # llama2_1b prefill at s = 1024
    # one row, a ragged 17, a ragged 1000 (8 kv tiles of 128, the last
    # short), S > T
    (1, 32, 32, 1, 1, 128), (1, 32, 32, 17, 17, 128),
    (1, 32, 32, 1000, 1000, 128), (2, 8, 2, 1000, 1000, 64),
    (1, 4, 2, 160, 100, 32)]
NORM_SHAPES = [(64, 256), (100, 300), (32, 2048), (7, 128), (2, 33, 160)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(gen, shape, dtype, std=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cuda_kernels_match_plain_versions(gen, dtype):
    tol = TOL[dtype]
    for (b, hq, hkv, s, t, hd) in FLASH_SHAPES:
        q = _randn(gen, (b, hq, s, hd), dtype)
        k = _randn(gen, (b, hkv, t, hd), dtype)
        v = _randn(gen, (b, hkv, t, hd), dtype)
        for causal in (True, False):
            n0 = flash_attention_cuda.launches
            g0 = flash_attention_cuda.sm90_launches
            m0 = flash_attention_cuda.mma_f32_launches
            got = flash_attention(q, k, v, causal, None, None)
            assert flash_attention_cuda.launches == n0 + 1
            # bf16 takes the TMA + wgmma kernel, f32 the mma kernel (3xTF32)
            assert flash_attention_cuda.sm90_launches == \
                g0 + (dtype == torch.bfloat16)
            assert flash_attention_cuda.mma_f32_launches == \
                m0 + (dtype == torch.float32)
            torch.testing.assert_close(
                got, reference_attention(q, k, v, causal=causal),
                rtol=tol, atol=tol)
    for shape in NORM_SHAPES:
        x = _randn(gen, shape, dtype)
        sc = _randn(gen, (shape[-1],), dtype, 0.1)
        n0 = rmsnorm_cuda.launches
        got = rmsnorm(x, sc, 1e-6, None)
        assert rmsnorm_cuda.launches == n0 + 1
        torch.testing.assert_close(got, reference_rmsnorm(x, sc),
                                   rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [  # (b, s, (hq, hkv, hkv), hd)
    (2, 100, (4, 2, 2), 64),
    (2, 1000, (32, 32, 32), 128)], ids=str)  # llama2_1b at (b, s) = (2, 1000)
def test_cuda_flash_reads_and_writes_the_model_layout(gen, dtype, shape):
    """(B, S, H, hd) activations passed transposed, as the model does: the
    output comes back in that layout with the plain version's values."""
    b, s, heads, hd = shape
    q, k, v = (_randn(gen, (b, s, h, hd), dtype).transpose(1, 2)
               for h in heads)
    g0 = flash_attention_cuda.sm90_launches
    got = flash_attention_cuda(q, k, v)
    assert flash_attention_cuda.sm90_launches == \
        g0 + (dtype == torch.bfloat16)
    assert got.stride() == q.stride()
    torch.testing.assert_close(got, reference_attention(q, k, v),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cuda_flash_at_hd256_matches_the_plain_version(gen, dtype):
    """Head dim 256 (gemma): the sm90 kernel's 64-key-tile instance for
    bf16, the mma kernel's f32 instance for f32; MQA and GQA, one row,
    ragged S, S < T, and gemma_2b's (8, 1024) request in the model
    layout."""
    for (b, hq, hkv, s, t) in [(1, 8, 1, 1, 1), (1, 8, 1, 17, 17),
                               (2, 8, 1, 100, 100), (1, 4, 2, 100, 160),
                               (8, 8, 1, 1024, 1024)]:
        q = _randn(gen, (b, s, hq, 256), dtype).transpose(1, 2)
        k, v = (_randn(gen, (b, t, hkv, 256), dtype).transpose(1, 2)
                for _ in range(2))
        for causal in (True, False):
            n0 = flash_attention_cuda.launches
            g0 = flash_attention_cuda.sm90_launches
            m0 = flash_attention_cuda.mma_f32_launches
            got = flash_attention(q, k, v, causal, None, None)
            assert flash_attention_cuda.launches == n0 + 1
            assert flash_attention_cuda.sm90_launches == \
                g0 + (dtype == torch.bfloat16)
            assert flash_attention_cuda.mma_f32_launches == \
                m0 + (dtype == torch.float32)
            assert got.stride() == q.stride()
            torch.testing.assert_close(
                got, reference_attention(q, k, v, causal=causal),
                rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
def test_gemma_prefill_at_full_width_launches_the_hd256_kernel(gen):
    """gemma_2b at full width with 2 layers: one plan serves two shapes,
    each request launches 2 sm90 flash kernels (the hd-256 instance) and
    5 RMSNorm kernels, and the logits agree with the plain plan's."""
    import dataclasses

    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.core import (TensorSpec, optimize, spec_like,
                                  symbolic_dims)
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    params = init_params(cfg, seed=0, device="cuda")
    B, S = symbolic_dims("b, s")
    specs = (spec_like(params), {"tokens": TensorSpec((B, S), torch.int32)})
    dims = {"b": (1, 4), "s": (16, 256)}
    opt = optimize(make_prefill_step(cfg), *specs, dynamic_dims=dims)
    plain = optimize(make_prefill_step(cfg, impl="ref"), *specs,
                     dynamic_dims=dims, kernel_select=False)
    flash = [sel for sel in opt.plan.kernel_selections.values()
             if sel.prim_name == "flash_attention"]
    assert [sel.variant.name for sel in flash] == ["sm90_bm128_bn128"] * 2
    for (b, s) in [(1, 16), (4, 256)]:
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                               device="cuda", dtype=torch.int32)
        f0, g0 = flash_attention_cuda.launches, \
            flash_attention_cuda.sm90_launches
        n0 = rmsnorm_cuda.launches
        got = opt(params, {"tokens": tokens})
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches - f0 == 2
        assert flash_attention_cuda.sm90_launches - g0 == 2
        assert rmsnorm_cuda.launches - n0 == 5
        assert tuple(got.shape) == (b, cfg.vocab)
        assert opt.last_report.stats.device_peak <= \
            opt.guaranteed_peak_bytes
        want = plain(params, {"tokens": tokens})
        torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                                   atol=5e-2)


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(gen):
    # every head dim up to 256 has a route (hd 48 the mma kernel's own
    # instance); past 256 none
    q = _randn(gen, (1, 2, 16, 320), torch.float32)      # hd 320
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, q, q)
    q = _randn(gen, (1, 2, 16, 64), torch.float16)
    with pytest.raises(ValueError, match="not supported"):
        flash_attention_cuda(q, q, q)
    q = _randn(gen, (1, 2, 64, 16), torch.float32).transpose(2, 3)
    with pytest.raises(ValueError, match="unit-stride"):
        flash_attention_cuda(q, q, q)
    # bf16 goes through TMA: a 136-byte row stride or a pointer 2 bytes off
    # 16 raises rather than taking another kernel
    n0 = flash_attention_cuda.launches
    q = _randn(gen, (1, 2, 16, 68), torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q, q, q)
    q = _randn(gen, (2 * 16 * 64 + 1,), torch.bfloat16)[1:].view(1, 2, 16, 64)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q, q, q)
    assert flash_attention_cuda.launches == n0
    x = _randn(gen, (8, 64), torch.float32).t()           # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_cuda(x, torch.zeros(8, device="cuda"))


@pytest.mark.gpu
def test_serving_path_launches_the_kernels(gen):
    from repro_torch.configs.llama2_1b import SMOKE
    from repro_torch.data import DataPipeline, PipelineConfig
    from repro_torch.launch.steps import adamw_config_for, make_train_step
    from repro_torch.launch.train import to_device
    from repro_torch.models import init_params
    from repro_torch.optim import init_state
    from repro_torch.core import (TensorSpec, optimize, spec_like,
                                  symbolic_dims)
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    params = init_params(SMOKE, seed=0)              # cuda by default
    B, S = symbolic_dims("b, s")
    specs = (spec_like(params), {"tokens": TensorSpec((B, S), torch.int32)})
    opt = optimize(make_prefill_step(SMOKE), *specs,
                   dynamic_dims={"b": (1, 8), "s": (16, 128)})
    plain = optimize(make_prefill_step(SMOKE, impl="ref"), *specs,
                     dynamic_dims={"b": (1, 8), "s": (16, 128)}, device="cuda",
                     kernel_select=False)
    for b, s in [(1, 16), (3, 96)]:
        tok = torch.randint(0, SMOKE.vocab, (b, s), generator=gen,
                            device="cuda", dtype=torch.int32)
        f0, n0 = flash_attention_cuda.launches, rmsnorm_cuda.launches
        g0 = flash_attention_cuda.sm90_launches
        got = opt(params, {"tokens": tok})
        assert flash_attention_cuda.launches - f0 == SMOKE.n_layers
        assert flash_attention_cuda.sm90_launches == g0   # SMOKE is f32
        assert rmsnorm_cuda.launches - n0 == 2 * SMOKE.n_layers + 1
        st = opt.last_report.stats
        assert st.device_peak <= opt.guaranteed_peak_bytes
        assert st.arena_bytes <= opt.arena_bound_bytes
        torch.testing.assert_close(got, plain(params, {"tokens": tok}),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_bucketed_prefill_launches_what_each_bucket_selected(gen, dtype):
    """A bucketed smoke-width prefill on the card: each request launches
    the kernels its bucket's plan selected, and a plain plan
    (``kernel_select=False``, ``impl="ref"``) launches none."""
    import dataclasses

    from repro_torch.configs.llama2_1b import SMOKE
    from repro_torch.data import DataPipeline, PipelineConfig
    from repro_torch.launch.steps import adamw_config_for, make_train_step
    from repro_torch.launch.train import to_device
    from repro_torch.models import init_params
    from repro_torch.optim import init_state
    from repro_torch.core import (TensorSpec, optimize, spec_like,
                                  symbolic_dims)
    from repro_torch.kernels.hw_model import HardwareModel
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    props = torch.cuda.get_device_properties(0)
    hw = HardwareModel.from_device("cuda")
    assert (hw.sm_count, hw.smem_per_block_optin, hw.regs_per_sm) == \
        (props.multi_processor_count, props.shared_memory_per_block_optin,
         props.regs_per_multiprocessor)
    cfg = dataclasses.replace(SMOKE, dtype=str(dtype).split(".")[1])
    params = init_params(cfg, seed=0)
    B, S = symbolic_dims("b, s")
    specs = (spec_like(params), {"tokens": TensorSpec((B, S), torch.int32)})
    dims = {"b": (1, 8), "s": (16, 128)}
    opt = optimize(make_prefill_step(cfg), *specs, dynamic_dims=dims,
                   buckets="geometric")
    plain = optimize(make_prefill_step(cfg, impl="ref"), *specs,
                     dynamic_dims=dims, buckets="geometric",
                     kernel_select=False)
    route = {"sm90_bm128_bn128": "sm90", "mma_f32_bq64_bkv64": "mma_f32",
             "cuda_reg_rows": "rmsnorm"}

    def counts():
        return {"sm90": flash_attention_cuda.sm90_launches,
                "mma_f32": flash_attention_cuda.mma_f32_launches,
                "rmsnorm": rmsnorm_cuda.launches}

    for b, s in [(1, 16), (3, 96), (8, 128)]:
        tok = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                       device="cuda", dtype=torch.int32)}
        c0 = counts()
        got = opt(params, tok)
        bp = opt.specialization_table.peek(opt.last_bucket)
        want = {"sm90": 0, "mma_f32": 0, "rmsnorm": 0}
        for sel in bp.plan.kernel_selections.values():
            want[route[sel.variant.name]] += 1
        assert {k: v - c0[k] for k, v in counts().items()} == want
        assert want["rmsnorm"] == 2 * cfg.n_layers + 1
        c0 = counts()
        ref = plain(params, tok)
        assert counts() == c0                  # the plain plan: no kernel
        st = opt.last_report.stats
        assert st.device_peak <= bp.report.peak_bound_bytes <= \
            opt.guaranteed_peak_bytes
        tol = TOL[dtype] if dtype == torch.float32 else 5e-2
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_kernel_ops_backward_on_the_card_matches_the_plain_route(gen, dtype):
    """The ops' backward is plain PyTorch on every route: through the CUDA
    forward it gives the plain route's gradients."""
    q = _randn(gen, (2, 8, 100, 64), dtype).requires_grad_()
    k = _randn(gen, (2, 4, 100, 64), dtype).requires_grad_()
    v = _randn(gen, (2, 4, 100, 64), dtype).requires_grad_()
    do = _randn(gen, (2, 8, 100, 64), dtype)
    n0 = flash_attention_cuda.launches
    got = torch.autograd.grad(flash_attention(q, k, v, True, None, None),
                              (q, k, v), do)
    assert flash_attention_cuda.launches == n0 + 1
    want = torch.autograd.grad(flash_attention(q, k, v, True, None, "ref"),
                               (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL[dtype], atol=TOL[dtype])
    x = _randn(gen, (3, 50, 256), dtype).requires_grad_()
    sc = _randn(gen, (256,), dtype, 0.1).requires_grad_()
    dy = _randn(gen, (3, 50, 256), dtype)
    n0 = rmsnorm_cuda.launches
    got = torch.autograd.grad(rmsnorm(x, sc, 1e-6, None), (x, sc), dy)
    assert rmsnorm_cuda.launches == n0 + 1
    want = torch.autograd.grad(rmsnorm(x, sc, 1e-6, "ref"), (x, sc), dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("layers,fracs", [(1, (0.95, 0.9)), (4, (0.9, 0.6))],
                         ids=["1-layer", "4-layer"])
def test_capped_train_step_on_the_card_equals_uncapped(gen, layers, fracs):
    """The smoke train step under memory limits: outputs bitwise equal to
    the uncapped step, device_peak under the limit, evictions to pinned
    host memory; with 4 layers at 0.6 some victims are recomputed (the
    full-width ladder in chip_smoke.py offloads every victim)."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from repro_torch.configs.llama2_1b import SMOKE
    from repro_torch.data import DataPipeline, PipelineConfig
    from repro_torch.launch.steps import adamw_config_for, make_train_step
    from repro_torch.launch.train import to_device
    from repro_torch.models import init_params
    from repro_torch.optim import init_state
    from repro_torch.core import (TensorSpec, optimize, spec_like,
                                  symbolic_dims)
    from repro_torch.launch.steps import adamw_config_for, make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import init_state

    cfg = dataclasses.replace(SMOKE, n_layers=layers, scan_layers=False)
    params = init_params(cfg, seed=0)
    opt_state = init_state(params, adamw_config_for(cfg))
    B, S = symbolic_dims("b, s")
    spec = {"tokens": TensorSpec((B, S), torch.int32),
            "labels": TensorSpec((B, S), torch.int32)}
    opt = optimize(make_train_step(cfg), spec_like(params),
                   spec_like(opt_state), spec,
                   dynamic_dims={"b": (1, 8), "s": (16, 512)})
    batch = {k: torch.randint(0, cfg.vocab, (8, 512), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in spec}
    want = pytree.tree_leaves(opt(params, opt_state, batch))
    peak = opt.last_report.stats.device_peak
    for frac in fracs:
        capped = opt.with_memory_limit(int(frac * peak))
        n0 = flash_attention_cuda.launches
        got = pytree.tree_leaves(capped(params, opt_state, batch))
        st = capped.last_report.stats
        assert flash_attention_cuda.launches - n0 >= layers
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert st.device_peak <= int(frac * peak)
        assert st.evictions > 0 and st.offloads > 0
    if layers == 4:
        assert st.recomputes > 0


LARGE_OVERHEAD = (1 << 20) + 512   # the caching allocator's most per block


@pytest.mark.gpu
def test_bounded_ffn_allocator_holds_the_tight_peak(gen):
    """The ragged-batch serve step at a reduced width and a quarter of the
    rows valid: the allocator's peak of the call stays within device_peak
    (tight) plus block overheads and the boolean index's indices, well
    below the pad-to-bound peak; the output equals the eager step."""
    import torch.nn.functional as F

    from repro_torch.core import TensorSpec, optimize, symbolic_dims
    from repro_torch.core.ir.dynamism import complete_bound_env
    from repro_torch.kernels import masked_select

    def step(x, mask, w1, w2):
        rows, n = masked_select(x, mask)
        return (F.gelu(rows @ w1, approximate="tanh") @ w2).sum(0), n

    n, d, f = 4096, 512, 1376
    bf16 = torch.bfloat16
    S, = symbolic_dims("s")
    fn = optimize(step, TensorSpec((S, d), bf16), TensorSpec((S,), torch.bool),
                  TensorSpec((d, f), bf16), TensorSpec((f, d), bf16),
                  dynamic_dims={"s": (1, n)})
    x, w1 = _randn(gen, (n, d), bf16), _randn(gen, (d, f), bf16, 0.05)
    w2 = _randn(gen, (f, d), bf16, 0.05)
    fn(x, torch.ones(n, dtype=torch.bool, device="cuda"), w1, w2)  # warm-up
    mask = torch.arange(n, device="cuda") < n // 4
    in_bytes = x.nbytes + n + w1.nbytes + w2.nbytes
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - in_bytes
    torch.cuda.reset_peak_memory_stats()
    out, cnt = fn(x, mask, w1, w2)
    torch.cuda.synchronize()
    step_alloc = torch.cuda.max_memory_allocated() - held
    st = fn.last_report.stats
    prog = fn.program
    stored = sum(len(c.store) for c in prog.computes)
    assert st.measured_dims == {"__b0": n // 4} and int(cnt) == n // 4
    assert step_alloc <= st.device_peak + stored * LARGE_OVERHEAD + \
        n * 8 + LARGE_OVERHEAD
    pad = prog.stats_for(prog.resolve(complete_bound_env(
        prog.graph, {"s": n}))).device_peak
    assert st.device_peak < pad
    rows = torch.masked_select(x, mask[:, None]).view(-1, d)
    want = (F.gelu(rows @ w1, approximate="tanh") @ w2).sum(0)
    torch.testing.assert_close(out, want, rtol=5e-2, atol=5e-2)


@pytest.mark.gpu
def test_rolled_decode_equals_unrolled_on_the_card(gen):
    """The rolled decode loop at a reduced width: bitwise equal to the
    unrolled plan at T = 17, one Loop instruction."""
    from repro_torch.core import TensorSpec, optimize, scan, symbolic_dims

    d, vocab, b, T = 512, 4000, 4, 17
    f32 = torch.float32

    def cell(w, h, p):
        h = torch.tanh(h @ w["wh"] + p)
        return h, (h @ w["wv"]).argmax(-1)

    def rolled_fn(w, h0, pos):
        return scan(lambda h, p: cell(w, h, p), h0.tanh(), pos)

    def unrolled_fn(w, h0, pos):
        h, toks = h0.tanh(), []
        for i in range(T):
            h, tok = cell(w, h, pos[i])
            toks.append(tok)
        return h, torch.stack(toks)

    w = {"wh": _randn(gen, (d, d), f32, 0.05),
         "wv": _randn(gen, (d, vocab), f32, 0.05)}
    h0, pos = _randn(gen, (b, d), f32, 0.2), _randn(gen, (T, d), f32, 0.1)
    w_specs = {k: TensorSpec(tuple(v.shape), f32) for k, v in w.items()}
    t, = symbolic_dims("t")
    rolled = optimize(rolled_fn, w_specs, TensorSpec((b, d), f32),
                      TensorSpec((t, d), f32), dynamic_dims={"t": (1, 64)})
    unrolled = optimize(unrolled_fn, w_specs, TensorSpec((b, d), f32),
                        TensorSpec((T, d), f32))
    assert rolled.program.counts()["Loop"] == 1
    h, toks = rolled(w, h0, pos)
    uh, utoks = unrolled(w, h0, pos)
    assert torch.equal(h, uh) and torch.equal(toks, utoks)
    st = rolled.last_report.stats
    assert st.arena_bytes <= rolled.arena_bound_bytes


def _smoke_prefill():
    from repro_torch.configs.llama2_1b import SMOKE
    from repro_torch.data import DataPipeline, PipelineConfig
    from repro_torch.launch.steps import adamw_config_for, make_train_step
    from repro_torch.launch.train import to_device
    from repro_torch.models import init_params
    from repro_torch.optim import init_state
    from repro_torch.core import (TensorSpec, optimize, spec_like,
                                  symbolic_dims)
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    params = init_params(SMOKE, seed=0)              # cuda by default
    B, S = symbolic_dims("b, s")
    opt = optimize(make_prefill_step(SMOKE), spec_like(params),
                   {"tokens": TensorSpec((B, S), torch.int32)},
                   dynamic_dims={"b": (1, 8), "s": (16, 128)})
    return SMOKE, params, opt


@pytest.mark.gpu
def test_memory_timeline_peak_holds_the_allocator(gen):
    """The replayed timeline's peak equals the plan's prediction and the
    call's device_peak, and the caching allocator's peak of the call (less
    what was held outside it) stays within it plus block overheads."""
    from torch.utils import _pytree as pytree

    cfg, params, opt = _smoke_prefill()
    param_bytes = sum(t.numel() * t.element_size()
                      for t in pytree.tree_leaves(params))
    stored = sum(len(c.store) for c in opt.program.computes)
    for b, s in [(1, 16), (3, 96), (8, 128)]:
        tok = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                            device="cuda", dtype=torch.int32)
        opt(params, {"tokens": tok})                 # warm-up
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - param_bytes - tok.nbytes
        torch.cuda.reset_peak_memory_stats()
        opt(params, {"tokens": tok})
        torch.cuda.synchronize()
        alloc = torch.cuda.max_memory_allocated() - held
        diff = opt.memory_timeline({"b": b, "s": s})
        assert diff.ok and diff.unexplained == []
        assert diff.actual.peak_device == diff.predicted_peak_device == \
            opt.last_report.stats.device_peak
        assert alloc <= diff.actual.peak_device + stored * LARGE_OVERHEAD


@pytest.mark.gpu
def test_disabled_telemetry_allocates_nothing_from_obs_on_the_card(gen):
    import os
    import tracemalloc

    import repro_torch.core.obs as obs_pkg

    cfg, params, opt = _smoke_prefill()
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    opt(params, batch)                               # warm every cache
    flt = tracemalloc.Filter(True, os.path.join(
        os.path.dirname(obs_pkg.__file__), "*"))
    tracemalloc.start(5)
    try:
        before = tracemalloc.take_snapshot().filter_traces([flt])
        for _ in range(5):
            opt(params, batch)
        after = tracemalloc.take_snapshot().filter_traces([flt])
    finally:
        tracemalloc.stop()
    torch.cuda.synchronize()
    grew = [d for d in after.compare_to(before, "lineno") if d.size_diff > 0]
    assert not grew, f"obs code allocated on the disabled path: {grew}"
    tel = opt.enable_telemetry()
    opt(params, batch)
    opt.disable_telemetry()
    assert tel.n_calls == 1


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card_is_bitwise(gen, tmp_path):
    """bf16 weights and f32 AdamW moments saved from the card and restored
    onto it, bit for bit (bf16 goes through its int16 bits)."""
    from torch.utils import _pytree as pytree

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim import AdamWState

    params = {"embed": _randn(gen, (512, 128), torch.bfloat16),
              "layers": [{"w": _randn(gen, (128, 344), torch.bfloat16)}
                         for _ in range(2)]}
    opt = AdamWState(step=torch.tensor(5, dtype=torch.int32, device="cuda"),
                     m=pytree.tree_map(lambda p: p.float() * 1e-3, params),
                     v=pytree.tree_map(lambda p: p.float() ** 2, params))
    state = {"params": params, "opt_state": opt}
    ck = Checkpointer(str(tmp_path))
    ck.save(5, state, blocking=False)
    ck.wait()
    step, got, _ = ck.restore()
    assert step == 5 and isinstance(got["opt_state"], AdamWState)
    ints = {2: torch.int16, 4: torch.int32}
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(state)):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.view(ints[w.element_size()]),
                           w.view(ints[w.element_size()]))


# the disc++ step's loss against the plain step's: about 3x the H100's
# reading of 3.4e-4 on the bf16 smoke model (batch 4, 204 useful tokens;
# the same plan on the CPU, where both routes are plain, reads 0): the two
# attention outputs round apart in bf16 and few tokens average it
PLAIN_LOSS_TOL = 1e-3


@pytest.mark.gpu
def test_table1_disc_pp_step_launches_the_sm90_kernel(gen):
    """One disc++ row of Table 1 (``benchmarks/torch_table1_dynamic_
    training.py``) on the bf16 smoke model, one step of a pipeline batch:
    it launches the sm90 flash kernel and RMSNorm (no f32 flash), its loss
    equals disc-dynamic's bit for bit (same shapes, same ops), and it is
    within ``PLAIN_LOSS_TOL`` of an eager call of the plain step
    (``impl="ref"``) on the same weights and batch."""
    import dataclasses
    import importlib.util
    import os

    from repro_torch.configs.llama2_1b import SMOKE
    from repro_torch.data import DataPipeline, PipelineConfig
    from repro_torch.launch.steps import adamw_config_for, make_train_step
    from repro_torch.launch.train import to_device
    from repro_torch.models import init_params
    from repro_torch.optim import init_state

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "benchmarks", "torch_table1_dynamic_training.py")
    spec = importlib.util.spec_from_file_location("torch_table1", path)
    t1 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t1)
    cfg = dataclasses.replace(SMOKE, dtype="bfloat16")
    rows = {}
    for system in ("disc++", "disc-dynamic"):
        sm90, f32 = flash_attention_cuda.sm90_launches, \
            flash_attention_cuda.launches
        norms = rmsnorm_cuda.launches
        rows[system] = t1.run_system(system, cfg, batch_size=4, steps=1,
                                     warmup=False)
        sm90 = flash_attention_cuda.sm90_launches - sm90
        f32 = flash_attention_cuda.launches - f32 - sm90
        assert sm90 == cfg.n_layers and f32 == 0
        assert rmsnorm_cuda.launches - norms == 2 * cfg.n_layers + 1
    pp, dyn = rows["disc++"], rows["disc-dynamic"]
    assert not pp["oom"] and pp["recompiles"] == 1 and pp["peak"] > 0
    assert torch.isfinite(torch.tensor(pp["losses"])).all()
    assert pp["losses"] == dyn["losses"]
    params = init_params(cfg, 0, device="cuda")
    raw = DataPipeline(PipelineConfig(vocab=cfg.vocab, batch_size=4,
                                      min_tokens=16, max_tokens=128)
                       ).next_batch()
    plain, _, _ = make_train_step(cfg, impl="ref")(
        params, init_state(params, adamw_config_for(cfg)),
        to_device(raw, torch.device("cuda")))
    assert abs(pp["losses"][0] - plain.item()) <= PLAIN_LOSS_TOL


def _resilient_smoke_prefill(gen):
    """The bf16 smoke prefill, bucketed, with the ladder attached, its
    weights, and an (8, 1024) request."""
    import dataclasses

    from repro_torch.configs.llama2_1b import SMOKE
    from repro_torch.core import (TensorSpec, optimize, spec_like,
                                  symbolic_dims)
    from repro_torch.core.resilience import ResilienceConfig, RetryPolicy
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    cfg = dataclasses.replace(SMOKE, dtype="bfloat16")
    params = init_params(cfg, seed=0)
    B, S = symbolic_dims("b, s")
    opt = optimize(make_prefill_step(cfg), spec_like(params),
                   {"tokens": TensorSpec((B, S), torch.int32)},
                   dynamic_dims={"b": (1, 8), "s": (16, 1024)},
                   buckets="geometric", resilience=ResilienceConfig(
                       retry=RetryPolicy(max_retries=2, backoff_base_s=0.0),
                       enforce_arena_bound=True))
    tok = {"tokens": torch.randint(0, cfg.vocab, (8, 1024), generator=gen,
                                   device="cuda", dtype=torch.int32)}
    return cfg, opt, params, tok


@pytest.mark.gpu
def test_transient_fault_at_an_sm90_flash_compute_retries_bitwise(gen):
    """chip_smoke phase 13 (b) at smoke width: a ``kernel`` fault just
    before the first sm90 flash launch retries the call in place, bitwise,
    and the retry launches every flash of the request."""
    from repro_torch.core.lowering.program import OP_COMPUTE
    from repro_torch.core.resilience import FaultPlan, FaultSpec

    cfg, opt, params, tok = _resilient_smoke_prefill(gen)
    want = opt(params, tok)                              # call 0
    program = opt.specialization_table.peek(opt.last_bucket).program
    computes = [x for x in program.fast_instructions if x.op == OP_COMPUTE]
    step = next(i for i, x in enumerate(computes)
                if "flash_attention" in x.node.prim_name)
    fp = FaultPlan([FaultSpec("kernel", call=1, step=step)])
    g0 = flash_attention_cuda.sm90_launches
    with opt.inject_faults(fp) as res:
        got = opt(params, tok)
    assert torch.equal(got, want)
    assert [e.rung for e in res.events] == ["retry-transient"]
    assert [(f.kind, f.step) for f in fp.fired] == [("kernel", step)]
    assert flash_attention_cuda.sm90_launches - g0 == cfg.n_layers


@pytest.mark.gpu
def test_a_real_oom_under_a_ballast_fails_structured(gen):
    """chip_smoke phase 13 (g) at smoke width: with a ballast leaving too
    little memory, the call raises ``torch.cuda.OutOfMemoryError`` inside
    the VM; the ladder retries on the whole-range plan, then rejects with
    the OOM as its cause; with the garbage collector off the failed call
    holds no memory, and after the ballast goes the next call is
    bitwise."""
    import gc

    from repro_torch.core.resilience import RequestFailed

    _cfg, opt, params, tok = _resilient_smoke_prefill(gen)
    want = opt(params, tok)
    enabled = gc.isenabled()
    gc.disable()
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        m0 = torch.cuda.memory_allocated()
        # fill the card and the allocator's free blocks, halving the piece
        # on each refusal
        size = torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved() \
            - m0
        ballast = []
        while size >= 2 << 20:
            try:
                ballast.append(torch.empty(size, dtype=torch.uint8,
                                           device="cuda"))
            except torch.cuda.OutOfMemoryError:
                size //= 2
        # the allocator's count (an unsplit block exceeds its tensor)
        n = torch.cuda.memory_allocated() - m0
        with pytest.raises(RequestFailed) as ei:
            opt(params, tok)
        e = ei.value
        assert isinstance(e.cause, torch.cuda.OutOfMemoryError)
        assert e.attempts == 3
        assert [ev.rung for ev in e.events] == \
            ["retry-fallback", "retry-fallback", "reject"]
        del e, ei
        assert torch.cuda.memory_allocated() == m0 + n
        del ballast
        assert torch.cuda.memory_allocated() == m0
    finally:
        if enabled:
            gc.enable()
    assert torch.equal(opt(params, tok), want)


def _offset_view(gen, shape, dtype):
    """A dense ``shape`` view one element past an aligned buffer's start."""
    n = shape[0] * shape[1] * shape[2] * shape[3]
    return _randn(gen, (n + 1,), dtype)[1:].view(shape)


def _check_mma(gen, dtype, hd, shapes):
    """The mma kernel at ``hd`` against the plain version at ``shapes``,
    in the model layout and with every pointer one element off, causal
    and not: one launch each on the mma route of its dtype."""
    counter = "mma_f32_launches" if dtype == torch.float32 \
        else "mma_bf16_launches"
    for (b, hq, hkv, s, t) in shapes:
        model = [_randn(gen, (b, n, h, hd), dtype).transpose(1, 2)
                 for n, h in ((s, hq), (t, hkv), (t, hkv))]
        offset = [_offset_view(gen, (b, h, n, hd), dtype)
                  for n, h in ((s, hq), (t, hkv), (t, hkv))]
        for q, k, v in (model, offset):
            for causal in (True, False):
                n0 = flash_attention_cuda.launches
                g0 = flash_attention_cuda.sm90_launches
                m0 = getattr(flash_attention_cuda, counter)
                got = flash_attention(q, k, v, causal, None, None)
                assert flash_attention_cuda.launches == n0 + 1
                assert flash_attention_cuda.sm90_launches == g0
                assert getattr(flash_attention_cuda, counter) == m0 + 1
                assert got.stride() == q.stride()
                torch.testing.assert_close(
                    got, reference_attention(q, k, v, causal=causal),
                    rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("hd", [12, 13, 16, 48])
def test_simt_flash_at_hd12_16_48_matches_the_plain_version(gen, dtype, hd):
    """The mma kernel (which took over from the SIMT kernel) at head dims
    the sm90 kernel has no instance for (hd 12 and 13 in its 16 instance,
    48 in its own), f32 and bf16: the smoke models' heads, one row, ragged
    S, S < T, and a (8, 1024) request, in the model layout and with every
    pointer one element off (hd 13 and the offset read with plain loads
    in bf16), causal and not; every launch on the mma route."""
    _check_mma(gen, dtype, hd, [(1, 6, 2, 1, 1), (1, 6, 2, 17, 17),
                                (2, 4, 2, 100, 100), (1, 4, 4, 100, 160),
                                (8, 4, 2, 1024, 1024)])


# every other mma instance: bf16 at head dims between the sm90 kernel's
# (24 -> 32, 40 -> 64, 100 -> 128, 200 -> 256), f32 at its own
MMA_INSTANCES = [(torch.bfloat16, hd) for hd in (24, 40, 100, 200)] + \
    [(torch.float32, hd) for hd in (32, 64, 100, 128, 200, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd", MMA_INSTANCES, ids=str)
def test_mma_flash_at_every_instance_matches_the_plain_version(gen, dtype,
                                                               hd):
    assert route_of(dtype, hd) == "mma"
    _check_mma(gen, dtype, hd, [(1, 4, 2, 1, 1), (2, 4, 2, 100, 100),
                                (1, 4, 2, 100, 160), (2, 8, 1, 300, 300)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite_8b", "starcoder2_7b",
                                  "musicgen_medium", "internvl2_2b"])
def test_dense_family_smoke_prefill_on_the_card(gen, arch, dtype):
    """The smoke configs (hd 16, starcoder2 hd 12) through one plan on the
    card: n_layers mma flash launches (of the dtype's kernel) and
    2 n_layers + 1 RMSNorm launches per request, the memory contracts,
    and logits against the plain plan (2e-4 in f32, 5e-2 in bf16)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import optimize, spec_like, symbolic_dims
    from repro_torch.launch.specs import batch_specs
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    params = init_params(cfg, seed=0)                # cuda by default
    B, S = symbolic_dims("b, s")
    specs = (spec_like(params), {k: v for k, v in batch_specs(cfg, B, S)
                                 .items() if k != "labels"})
    dims = {"b": (1, 8), "s": (16, 128)}
    opt = optimize(make_prefill_step(cfg), *specs, dynamic_dims=dims)
    plain = optimize(make_prefill_step(cfg, impl="ref"), *specs,
                     dynamic_dims=dims, kernel_select=False)
    tol = 2e-4 if dtype == "float32" else 5e-2
    for b, s in [(1, 16), (3, 96)]:
        batch = {}
        if cfg.input_mode == "embeddings":
            batch["frame_embed"] = _randn(gen, (b, s, cfg.d_model),
                                          cfg.torch_dtype)
        else:
            if cfg.input_mode == "vlm":
                batch["vis_embed"] = _randn(
                    gen, (b, cfg.vis_tokens, cfg.d_model), cfg.torch_dtype)
            batch["tokens"] = torch.randint(0, cfg.vocab, (b, s),
                                            generator=gen, device="cuda",
                                            dtype=torch.int32)
        f0, n0 = flash_attention_cuda.launches, rmsnorm_cuda.launches
        g0 = flash_attention_cuda.sm90_launches
        b0 = flash_attention_cuda.mma_bf16_launches
        m0 = flash_attention_cuda.mma_f32_launches
        got = opt(params, batch)
        assert flash_attention_cuda.launches - f0 == cfg.n_layers
        assert flash_attention_cuda.sm90_launches == g0
        assert flash_attention_cuda.mma_bf16_launches - b0 == \
            (cfg.n_layers if dtype == "bfloat16" else 0)
        assert flash_attention_cuda.mma_f32_launches - m0 == \
            (cfg.n_layers if dtype == "float32" else 0)
        assert rmsnorm_cuda.launches - n0 == 2 * cfg.n_layers + 1
        st = opt.last_report.stats
        assert st.device_peak <= opt.guaranteed_peak_bytes
        assert st.arena_bytes <= opt.arena_bound_bytes
        want = plain(params, batch)
        torch.testing.assert_close(got[..., :cfg.vocab].float(),
                                   want[..., :cfg.vocab].float(),
                                   rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
def test_mma_flash_at_kimis_hd112_matches_the_plain_version(gen, offset):
    """kimi_k2's attention (64/8 heads, hd 112, bf16) takes the mma
    kernel's 128 instance: its model-layout views copy 16 bytes wide (one
    element off, plain loads), causal and not, one row, ragged S, S < T."""
    import math

    from repro_torch.kernels.flash_attention import mma_copy_width
    hd = 112
    assert route_of(torch.bfloat16, hd) == "mma"
    for (b, s, t) in [(1, 1, 1), (2, 100, 100), (1, 37, 160), (2, 256, 256)]:
        def view(n, h):
            if offset:
                flat = _randn(gen, (b * n * h * hd + 1,), torch.bfloat16)
                return flat[1:].view(b, n, h, hd).transpose(1, 2)
            return _randn(gen, (b, n, h, hd), torch.bfloat16).transpose(1, 2)
        q, k, v = view(s, 64), view(t, 8), view(t, 8)
        width = mma_copy_width(hd, 2, [(x.shape, x.stride(), x.data_ptr())
                                       for x in (q, k, v)])
        assert width == (0 if offset else 16)
        for causal in (True, False):
            m0 = flash_attention_cuda.mma_bf16_launches
            got = flash_attention(q, k, v, causal, None, None)
            assert flash_attention_cuda.mma_bf16_launches == m0 + 1
            want = reference_attention(q, k, v, causal=causal)
            torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
            rel = ((got.float() - want.float()).norm()
                   / want.float().norm()).item()
            assert math.isfinite(rel) and rel <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [7168, 1536, 512])
def test_rmsnorm_at_the_moe_widths_matches_the_plain_version(gen, dtype, d):
    """d_model 7168 (kimi_k2, deepseek_v3) and MLA's latent norms, q_norm
    at 1536 and kv_norm at 512."""
    for rows in (1, 300, 4096):
        x = _randn(gen, (rows, d), dtype)
        sc = _randn(gen, (d,), dtype, 0.1)
        n0 = rmsnorm_cuda.launches
        got = rmsnorm(x, sc, 1e-6, None)
        assert rmsnorm_cuda.launches == n0 + 1
        torch.testing.assert_close(got, reference_rmsnorm(x, sc),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "deepseek_v3_671b"])
def test_moe_smoke_prefill_on_the_card(gen, arch):
    """The MoE smoke configs eagerly on the card: per request one mma flash
    a GQA layer (kimi, hd 16) and none for MLA, RMSNorm ln1, ln2 (and
    q_norm, kv_norm) a layer and the final norm; in f32 the logits equal
    the plain path's (``impl="ref"``) to 2e-4; in bf16 the routing is the
    plain path's, pair for pair, and the logits finite."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, prefill
    from repro_torch.models.ffn import observe_routing

    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
        params = init_params(cfg, seed=0)            # cuda by default
        mla = cfg.attn_kind == "mla"
        for b, s in [(1, 16), (3, 96)]:
            batch = {"tokens": torch.randint(0, cfg.vocab, (b, s),
                                             generator=gen, device="cuda",
                                             dtype=torch.int32)}
            f0, n0 = flash_attention_cuda.launches, rmsnorm_cuda.launches
            k_routes, p_routes = [], []
            with observe_routing(k_routes.append):
                got = prefill(cfg, params, batch)
            assert flash_attention_cuda.launches - f0 == \
                (0 if mla else cfg.n_layers)
            assert rmsnorm_cuda.launches - n0 == \
                (4 if mla else 2) * cfg.n_layers + 1
            with observe_routing(p_routes.append):
                want = prefill(cfg, params, batch, impl="ref")
            assert torch.isfinite(got.float()).all()
            if dtype == "float32":
                torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
            else:
                for rk, rp in zip(k_routes, p_routes):
                    assert torch.equal(rk.dest, rp.dest)
                    assert torch.equal(rk.token_of, rp.token_of)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "deepseek_v3_671b"])
def test_moe_serve_on_the_card_is_deterministic(gen, arch):
    """``serve`` in bf16 twice gives the same greedy tokens and the same
    prompt logits bit for bit (the MoE combine sums each token's slots in
    a fixed order; no atomics), with a latent cache for deepseek."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.mla import MLACache

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    r1 = serve(cfg, batch=4, prompt_len=16, gen=8, seed=1)
    r2 = serve(cfg, batch=4, prompt_len=16, gen=8, seed=1)
    assert r1["tokens"].shape == (4, 8)
    assert (r1["tokens"] == r2["tokens"]).all()
    assert torch.equal(r1["prompt_logits"], r2["prompt_logits"])
    kv = r1["state"].caches[0].kv
    assert isinstance(kv, MLACache) == (cfg.attn_kind == "mla")
    assert int(kv.length) == 24


# -- RMSNorm: the register path at every config width, the loop path ---------

NORM_WIDTHS = (512, 1536, 2048, 3072, 4096, 4608, 7168)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", NORM_WIDTHS)
def test_rmsnorm_register_path_matches_plain_at_every_config_width(gen, d,
                                                                   dtype):
    from repro_torch.kernels.rmsnorm import rmsnorm_geometry
    assert rmsnorm_geometry(d, dtype).path == "reg"
    sc = _randn(gen, (d,), dtype, 0.1)
    for rows in (1, 3, 8, 8192):
        x = _randn(gen, (rows, d), dtype)
        n0, r0 = rmsnorm_cuda.launches, rmsnorm_cuda.reg_launches
        l0 = rmsnorm_cuda.loop_launches
        got = rmsnorm(x, sc, 1e-6, None)
        assert (rmsnorm_cuda.launches - n0, rmsnorm_cuda.reg_launches - r0,
                rmsnorm_cuda.loop_launches - l0) == (1, 1, 0)
        torch.testing.assert_close(got, reference_rmsnorm(x, sc),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_rmsnorm_rows_are_bitwise_alone_and_in_any_call(gen, dtype):
    """The geometry depends on (d, dtype) only: a row's result is the same
    bits alone, inside a 4-row call and inside the whole call."""
    for d in NORM_WIDTHS:
        x = _randn(gen, (1000, d), dtype)
        sc = _randn(gen, (d,), dtype, 0.1)
        y = rmsnorm_cuda(x, sc)
        for i in (0, 1, 517, 999):
            j = min(i, 996)
            assert torch.equal(rmsnorm_cuda(x[i:i + 1], sc)[0], y[i])
            assert torch.equal(rmsnorm_cuda(x[j:j + 4], sc)[i - j], y[i])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_rmsnorm_loop_path_takes_offsets_and_wide_rows(gen, dtype):
    """A view one element off a 16-byte boundary, a width that is not a
    whole number of vectors, one vector past the register path's widest
    row, d 16384 and d 16392 run on the loop path, against plain."""
    from repro_torch.kernels.rmsnorm import max_reg_width, tensor_geometry
    flat = _randn(gen, (3 * 4096 + 1,), dtype)
    past = max_reg_width(dtype) + 16 // dtype.itemsize
    cases = [flat[1:].view(3, 4096), _randn(gen, (5, 4099), dtype),
             _randn(gen, (2, past), dtype), _randn(gen, (2, 16384), dtype),
             _randn(gen, (2, 16392), dtype)]
    for x in cases:
        sc = _randn(gen, (x.shape[-1],), dtype, 0.1)
        assert tensor_geometry(x, sc, torch.empty_like(x)).path == "loop"
        r0, l0 = rmsnorm_cuda.reg_launches, rmsnorm_cuda.loop_launches
        got = rmsnorm_cuda(x, sc)
        assert (rmsnorm_cuda.reg_launches - r0,
                rmsnorm_cuda.loop_launches - l0) == (0, 1)
        torch.testing.assert_close(got, reference_rmsnorm(x, sc),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_rmsnorm_widest_register_row_matches_plain(gen, dtype):
    """The widest row the register path takes runs there, in the
    instance with the most vectors a thread."""
    from repro_torch.kernels.rmsnorm import max_reg_width
    d = max_reg_width(dtype)
    x, sc = _randn(gen, (3, d), dtype), _randn(gen, (d,), dtype, 0.1)
    r0 = rmsnorm_cuda.reg_launches
    got = rmsnorm_cuda(x, sc)
    assert rmsnorm_cuda.reg_launches == r0 + 1
    torch.testing.assert_close(got, reference_rmsnorm(x, sc),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
def test_rmsnorm_entry_point_refuses_a_geometry_that_does_not_cover_d(gen):
    """The C entry point checks what Python hands it: too few vectors a
    row, or the register path on an offset pointer, is an invalid value."""
    from dataclasses import replace

    from repro_torch.kernels.rmsnorm import launch_rmsnorm, rmsnorm_geometry
    x = _randn(gen, (4, 4096), torch.bfloat16)
    sc = _randn(gen, (4096,), torch.bfloat16, 0.1)
    out = torch.empty_like(x)
    geo = rmsnorm_geometry(4096, torch.bfloat16)
    n0 = rmsnorm_cuda.launches
    with pytest.raises(RuntimeError, match="rmsnorm launch"):
        launch_rmsnorm(x, sc, out, replace(geo, vecs_per_thread=1), 1e-6)
    flat = _randn(gen, (4 * 4096 + 8,), torch.bfloat16)
    with pytest.raises(RuntimeError, match="rmsnorm launch"):
        launch_rmsnorm(flat[8 - 1:-1].view(4, 4096), sc, out, geo, 1e-6)
    assert rmsnorm_cuda.launches == n0
    launch_rmsnorm(x, sc, out, geo, 1e-6)
    torch.testing.assert_close(out, reference_rmsnorm(x, sc), rtol=1e-2,
                               atol=1e-2)


# -- xLSTM: the smoke config on the card --------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_smoke_forward_and_decode_on_the_card(gen, dtype):
    """The xLSTM smoke config eagerly on the card: no flash launch; per
    request and per decode step a pre-norm a layer, the final norm and
    every mLSTM layer's output norm on the RMSNorm kernel (in decode the
    output norm's input is f32 whatever the model dtype); the logits equal
    the plain path's (``impl="ref"``) to 2e-4 in f32 and 5e-2 in bf16; in
    f32 one decode step equals the forward's first position to 2e-4."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params)
    from repro_torch.models.lm import xlstm_meta

    cfg = dataclasses.replace(get_smoke_config("xlstm_1p3b"), dtype=dtype)
    meta = xlstm_meta(cfg)
    norms = cfg.n_layers + 1 + meta["n_groups"] * meta["m_per_group"]
    tol = 2e-4 if dtype == "float32" else 5e-2
    params = init_params(cfg, seed=0)                # cuda by default
    toks = torch.randint(0, cfg.vocab, (3, 150), generator=gen,
                         device="cuda", dtype=torch.int32)
    f0, n0 = flash_attention_cuda.launches, rmsnorm_cuda.launches
    got = forward(cfg, params, {"tokens": toks})
    assert flash_attention_cuda.launches == f0
    assert rmsnorm_cuda.launches - n0 == norms
    want = forward(cfg, params, {"tokens": toks}, impl="ref")
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    state = init_cache(cfg, 3, max_len=2)
    n0 = rmsnorm_cuda.launches
    step, state = decode_step(cfg, params, state, {"token": toks[:, :1]})
    assert rmsnorm_cuda.launches - n0 == norms
    assert state.xlstm[0][0][0].c.dtype == torch.float32
    if dtype == "float32":
        torch.testing.assert_close(step[:, 0], got[:, 0], rtol=tol, atol=tol)



# -- serve's compiled decode step ------------------------------------------------

DECODE_ARCHS = ["llama2_1b", "gemma_2b", "musicgen_medium", "internvl2_2b",
                "kimi_k2_1t_a32b", "deepseek_v3_671b", "hymba_1p5b",
                "xlstm_1p3b"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_compiled_decode_is_the_eager_step_on_the_card(gen, arch, dtype):
    """``serve``'s plan (``decode_plan``, b symbolic in [1, 8], 49 rows) at
    each family's smoke config: its logits and every state leaf bitwise
    equal to the eager ``decode_step`` at b = 1, 3, 8 from a cache 17
    steps in, with the same RMSNorm kernel launches a step."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.ir.capture import tree_flatten
    from repro_torch.launch.serve import decode_plan
    from repro_torch.models import decode_step, init_cache, init_params

    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    params = init_params(cfg, seed=0)
    plan = decode_plan(cfg, params, max_len=49)
    assert plan.report.guards == []
    for b in (1, 3, 8):
        def inp():
            if cfg.input_mode == "embeddings":
                return {"frame_embed": _randn(gen, (b, 1, cfg.d_model),
                                              cfg.torch_dtype)}
            return {"token": torch.randint(1, cfg.vocab, (b, 1),
                                           generator=gen, device="cuda",
                                           dtype=torch.int32)}
        state = init_cache(cfg, b, 49)
        for _ in range(17):
            _, state = decode_step(cfg, params, state, inp())
        x = inp()
        n0 = rmsnorm_cuda.launches
        want = decode_step(cfg, params, state, x)
        n_eager = rmsnorm_cuda.launches - n0
        got = plan(params, state, x)
        assert rmsnorm_cuda.launches - n0 == 2 * n_eager > 0
        (g, g_tree), (w, w_tree) = tree_flatten(got), tree_flatten(want)
        assert g_tree == w_tree
        for i, (a, c) in enumerate(zip(g, w)):
            assert torch.equal(a, c), f"b {b}: leaf {i}"


@pytest.mark.gpu
def test_serve_raises_where_capture_refuses_on_the_card(gen, monkeypatch):
    """No eager fallback: a step that reads a device value on the host
    raises out of ``serve``; the step never runs eagerly."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import decode_step

    calls = []

    def host_read(c, p, s, i):
        calls.append(int(s.caches[0].kv.length))
        return decode_step(c, p, s, i)

    monkeypatch.setattr(serve_mod, "decode_step", host_read)
    with pytest.raises(Exception, match="data-dependent|Data dependent"):
        serve_mod.serve(get_smoke_config("llama2_1b"), batch=2,
                        prompt_len=3, gen=2)
    assert calls == []


# -- gradient accumulation, compression and the opaque scan node ---------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("option", ["grad_accum", "compress"])
def test_accum_and_compress_steps_are_the_eager_step_on_the_card(
        gen, option, dtype):
    """The smoke ``make_train_step(grad_accum=2)`` (b static at 4) and
    ``(compress=True)`` (b and s symbolic; two steps, the second from the
    first's error) through ``optimize``: every output leaf bitwise equal
    to the eager step's, with its kernel launches.  Kernel selection is
    off, so the plan's ops route as eager's do."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from repro_torch.configs.llama2_1b import SMOKE
    from repro_torch.core import (TensorSpec, optimize, spec_like,
                                  symbolic_dims)
    from repro_torch.distributed import init_compression_state
    from repro_torch.launch.steps import adamw_config_for, make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import init_state

    cfg = dataclasses.replace(SMOKE, dtype=dtype, scan_layers=False)
    params = init_params(cfg, seed=0)
    state = [params, init_state(params, adamw_config_for(cfg))]
    B, S = symbolic_dims("b, s")
    if option == "grad_accum":
        step = make_train_step(cfg, grad_accum=2)
        b_dim, dims = 4, {"s": (16, 64)}
    else:
        step = make_train_step(cfg, compress=True)
        state.append(init_compression_state(params))
        b_dim, dims = B, {"b": (1, 8), "s": (16, 64)}
    spec = {k: TensorSpec((b_dim, S), torch.int32)
            for k in ("tokens", "labels")}
    opt = optimize(step, *[spec_like(x) for x in state], spec,
                   dynamic_dims=dims, kernel_select=False)
    assert opt.report.guards == []
    for s in (16, 40):
        batch = {k: torch.randint(0, cfg.vocab, (4, s), generator=gen,
                                  device="cuda", dtype=torch.int32)
                 for k in spec}
        n0 = (flash_attention_cuda.launches, rmsnorm_cuda.launches)
        want = step(*state, batch)
        n1 = (flash_attention_cuda.launches, rmsnorm_cuda.launches)
        got = opt(*state, batch)
        n2 = (flash_attention_cuda.launches, rmsnorm_cuda.launches)
        assert n2[0] - n1[0] == n1[0] - n0[0] > 0
        assert n2[1] - n1[1] == n1[1] - n0[1] > 0
        g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
        assert len(g) == len(w)
        for i, (a, c) in enumerate(zip(g, w)):
            assert torch.equal(a, c), f"s {s}: leaf {i}"
        if option == "compress":
            state = list(got[1:])       # the next step from this error


def _scan_norms(x, scales):
    """Four RMSNorms in a row as a static-length ``core.scan``."""
    from repro_torch.core import scan

    def body(h, scale):
        h = rmsnorm(h, scale, 1e-6, None)
        return h, h.float().square().mean(-1)
    return scan(body, x, scales)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_opaque_scan_is_the_eager_loop_on_the_card(gen, dtype):
    """A static-length scan is one opaque node; its plan, on the VM and
    the interpreter, is bitwise the eager loop, with one RMSNorm kernel
    launch an iteration."""
    from repro_torch.core import TensorSpec, optimize, symbolic_dims

    B, S = symbolic_dims("b, s")
    specs = (TensorSpec((B, S, 256), dtype), TensorSpec((4, 256), dtype))
    dims = {"b": (1, 8), "s": (1, 64)}
    fn = optimize(_scan_norms, *specs, dynamic_dims=dims)
    ref = optimize(_scan_norms, *specs, dynamic_dims=dims,
                   executor="reference")
    assert [n.prim_name for n in fn.plan.graph.nodes] == ["scan"]
    for b, s in ((1, 16), (3, 40), (8, 64)):
        x = _randn(gen, (b, s, 256), dtype)
        scales = _randn(gen, (4, 256), dtype, 0.1)
        want = _scan_norms(x, scales)
        n0 = rmsnorm_cuda.launches
        got = fn(x, scales)
        assert rmsnorm_cuda.launches - n0 == 4
        other = ref(x, scales)
        for a, c, o in zip(got, want, other):
            assert torch.equal(a, c) and torch.equal(a, o)
        assert fn.last_report.stats.as_dict() == \
            ref.last_report.stats.as_dict()


@pytest.mark.gpu
@pytest.mark.parametrize("executor", ["vm", "reference"])
def test_an_opaque_body_that_fails_on_the_card_raises(gen, executor):
    """No fallback: a body op that refuses its input on the card (the
    sm90 flash kernel asked for f32) raises out of the call."""
    from repro_torch.core import TensorSpec, optimize, scan

    def f(q, xs):
        def body(h, x):
            h = flash_attention(h + x, h, h, True, None, "sm90_bm128_bn128")
            return h, h.sum(-1)
        return scan(body, q, xs)

    fn = optimize(f, TensorSpec((1, 2, 16, 64), torch.float32),
                  TensorSpec((3, 1, 2, 16, 64), torch.float32),
                  executor=executor)
    assert [n.prim_name for n in fn.plan.graph.nodes] == ["scan"]
    q = _randn(gen, (1, 2, 16, 64), torch.float32)
    xs = _randn(gen, (3, 1, 2, 16, 64), torch.float32)
    n0 = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="takes torch.bfloat16"):
        fn(q, xs)
    assert flash_attention_cuda.launches == n0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compiled_trainer_on_the_card_matches_the_dynamic_one(gen, dtype):
    """``train(mode="compiled")`` at smoke size on the card: one plan per
    bucketed batch shape, each call within its plan's bound, the sm90 or
    f32 flash and RMSNorm launched every step (each block's again in its
    recompute: the compiled path's block remat), the losses within the
    dtype's tolerance of ``mode="dynamic"``'s (the flat graph) on the
    same batches."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.llama2_1b import SMOKE
    from repro_torch.launch.train import train

    cfg = dataclasses.replace(SMOKE, dtype=dtype)
    f0, n0 = flash_attention_cuda.launches, rmsnorm_cuda.launches
    compiled = train(cfg, steps=6, batch_size=4, mode="compiled",
                     data_mode="bucketed", log_every=100)
    steps = 6
    assert flash_attention_cuda.launches - f0 == steps * 2 * cfg.n_layers
    assert rmsnorm_cuda.launches - n0 == steps * (4 * cfg.n_layers + 1)
    plans = compiled["steps_by_shape"]
    assert compiled["recompilations"] == len(plans.plans) <= 4
    for key, fn in plans.plans.items():
        assert fn.last_report.stats.device_peak <= \
            plans.guaranteed_peak_bytes[key]
    dynamic = train(cfg, steps=6, batch_size=4, mode="dynamic",
                    data_mode="bucketed", log_every=100)
    tol = 2e-4 if dtype == "float32" else PLAIN_LOSS_TOL
    assert np.all(np.isfinite(compiled["losses"]))
    np.testing.assert_allclose(compiled["losses"], dynamic["losses"],
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_remat_step_on_the_card_is_the_flat_step(gen, dtype):
    """The compiled path's step at (2, 128) with ``remat_policy`` "block"
    and "none", one static plan each on the same state and batch: every
    output bitwise equal; one checkpointed step launches each block's
    flash and two norms twice (the forward, the backward's recompute)
    and the final norm once, the flat step once each."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from repro_torch.configs.llama2_1b import SMOKE
    from repro_torch.launch.steps import adamw_config_for
    from repro_torch.launch.train import CompiledSteps
    from repro_torch.models import init_params
    from repro_torch.optim import init_state

    batch = {k: torch.randint(0, SMOKE.vocab, (2, 128), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    batch["mask"] = torch.ones((2, 128), device="cuda")
    outs = {}
    for pol in ("block", "none"):
        cfg = dataclasses.replace(SMOKE, dtype=dtype, remat_policy=pol)
        params = init_params(cfg, seed=0)
        opt_state = init_state(params, adamw_config_for(cfg))
        fn = CompiledSteps(cfg, params, opt_state).plan_for(batch)
        f0, n0 = flash_attention_cuda.launches, rmsnorm_cuda.launches
        out = fn(params, opt_state, batch)
        torch.cuda.synchronize()
        k = 2 if pol == "block" else 1
        assert flash_attention_cuda.launches - f0 == k * cfg.n_layers
        assert rmsnorm_cuda.launches - n0 == 2 * k * cfg.n_layers + 1
        assert torch.isfinite(out[0])
        outs[pol] = pytree.tree_leaves(out)
    assert all(torch.equal(a, b) for a, b in zip(outs["block"], outs["none"]))


@pytest.mark.gpu
def test_restore_onto_a_1x1_nccl_mesh_is_bitwise(gen, tmp_path):
    """bf16 weights and f32 moments restored as DTensors on a 1x1 mesh of
    a one-process NCCL world: every local tensor on the card, bitwise the
    saved one; the group is destroyed after."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import spec_like
    from repro_torch.launch.mesh import destroy_world, make_debug_mesh
    from repro_torch.launch.sharding import ShardingRules
    from repro_torch.optim import AdamWState

    params = {"embed": _randn(gen, (512, 128), torch.bfloat16),
              "layers": [{"attn": {"wq": _randn(gen, (128, 128),
                                                torch.bfloat16)}}
                         for _ in range(2)]}
    opt = AdamWState(step=torch.tensor(5, dtype=torch.int32, device="cuda"),
                     m=pytree.tree_map(lambda p: p.float() * 1e-3, params),
                     v=pytree.tree_map(lambda p: p.float() ** 2, params))
    state = {"params": params, "opt_state": opt}
    ck = Checkpointer(str(tmp_path))
    ck.save(5, state)
    destroy_world()
    try:
        rules = ShardingRules(make_debug_mesh(1, 1))
        assert dist.get_backend() == "nccl"
        shardings = {k: rules.named(rules.params_pspecs(spec_like(v)))
                     for k, v in state.items()}
        _, got, _ = ck.restore(shardings=shardings)
        for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(state)):
            assert isinstance(g, DTensor)
            local = g.to_local()
            assert local.device.type == "cuda" and local.dtype == w.dtype
            assert torch.equal(local, w)
    finally:
        destroy_world()
    assert not dist.is_initialized()


def _strategy_inputs(gen, dtype):
    """q, k, v as the model hands them to flash attention ((B, S, H, hd)
    activations transposed), and an RMSNorm input and scale."""
    q = _randn(gen, (2, 256, 8, 64), dtype).transpose(1, 2)
    k = _randn(gen, (2, 256, 2, 64), dtype).transpose(1, 2)
    v = _randn(gen, (2, 256, 2, 64), dtype).transpose(1, 2)
    x = _randn(gen, (2, 256, 512), dtype)
    scale = _randn(gen, (512,), dtype, 0.1)
    return q, k, v, x, scale


def _on_1x1_mesh(fn):
    """``fn(mesh)`` on a 1x1 mesh of a one-process NCCL world, destroyed
    after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import destroy_world, make_debug_mesh
    destroy_world()
    try:
        mesh = make_debug_mesh(1, 1)
        assert dist.get_backend() == "nccl"
        return fn(mesh)
    finally:
        destroy_world()


MESH_PLACEMENTS = [("replicate", ((0, None), (0, None))),
                   ("batch-heads", ((0, 0), (0, 1)))]


def _placements(spec):
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if d is None else Shard(d) for _, d in spec]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_kernel_strategies_on_a_1x1_nccl_mesh_are_bitwise(gen, dtype):
    """flash attention and RMSNorm on DTensors, through their sharding
    strategies (``launch.strategies``), launch their kernels once each and
    equal the direct kernel calls bit for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.strategies import sharded_execution
    q, k, v, x, scale = _strategy_inputs(gen, dtype)
    want_o = flash_attention(q, k, v, True, None, None)
    want_n = rmsnorm(x, scale, 1e-6, None)

    def run(mesh):
        for _, spec in MESH_PLACEMENTS:
            pl = _placements(spec)
            d = [DTensor.from_local(t, mesh, pl) for t in (q, k, v, x)]
            ds = DTensor.from_local(scale, mesh, _placements(
                ((0, None), (0, None))))
            f0, n0 = flash_attention_cuda.launches, rmsnorm_cuda.launches
            with sharded_execution():
                o = flash_attention(d[0], d[1], d[2], True, None, None)
                n = rmsnorm(d[3], ds, 1e-6, None)
            assert flash_attention_cuda.launches == f0 + 1
            assert rmsnorm_cuda.launches == n0 + 1
            assert torch.equal(o.to_local(), want_o)
            assert o.to_local().stride() == want_o.stride()
            assert torch.equal(n.to_local(), want_n)
    _on_1x1_mesh(run)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_kernel_strategies_backward_on_a_1x1_nccl_mesh_is_bitwise(gen,
                                                                  dtype):
    """The ops' plain gradients (flash's on the local shards at the
    forward's placements, RMSNorm's as aten ops on the DTensors) give the
    direct call's gradients bit for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.strategies import sharded_execution
    q, k, v, x, scale = _strategy_inputs(gen, dtype)
    go = _randn(gen, q.shape, dtype)
    gn = _randn(gen, x.shape, dtype)

    def grads(args, wrap=lambda t, i: t, ctx=None):
        leaves = [a.detach().requires_grad_() for a in args]
        w = [wrap(t, i) for i, t in enumerate(leaves)]
        import contextlib
        with ctx or contextlib.nullcontext():
            o = flash_attention(w[0], w[1], w[2], True, None, None)
            n = rmsnorm(w[3], w[4], 1e-6, None)
            gw = [wrap(go, 0), wrap(gn, 3)]
            torch.autograd.backward([o, n], gw)
        return [t.grad for t in leaves]

    want = grads((q, k, v, x, scale))

    def run(mesh):
        for _, spec in MESH_PLACEMENTS:
            pl = _placements(spec)
            rep = _placements(((0, None), (0, None)))

            def wrap(t, i):
                return DTensor.from_local(t, mesh, rep if i == 4 else pl)
            got = grads((q, k, v, x, scale), wrap, sharded_execution())
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)
    _on_1x1_mesh(run)
