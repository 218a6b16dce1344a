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

# bf16: one rounding of the output is 2^-8 relative; kernel and plain
# version may round one ulp apart, which 1e-2 covers and a lost kv tile
# does not
TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
FLASH_SHAPES = [  # (b, hq, hkv, s, t, hd): tests/test_kernels.py + S != T
    (2, 4, 2, 256, 256, 64), (1, 8, 1, 128, 128, 128),
    (2, 4, 4, 100, 100, 64), (1, 6, 2, 384, 384, 32),
    (3, 2, 1, 64, 64, 64), (1, 4, 2, 100, 160, 64),
    (1, 32, 32, 1024, 1024, 128)]  # llama2_1b prefill at s = 1024
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
            got = flash_attention(q, k, v, causal, None, None)
            assert flash_attention_cuda.launches == n0 + 1
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
def test_cuda_flash_reads_and_writes_the_model_layout(gen, dtype):
    """(B, S, H, hd) activations passed transposed, as the model does: the
    output comes back in that layout with the plain version's values."""
    q, k, v = (_randn(gen, (2, 100, h, 64), dtype).transpose(1, 2)
               for h in (4, 2, 2))
    got = flash_attention_cuda(q, k, v)
    assert got.stride() == q.stride()
    torch.testing.assert_close(got, reference_attention(q, k, v),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _randn(gen, (1, 2, 16, 48), torch.float32)       # hd 48
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, q, q)
    q = _randn(gen, (1, 2, 16, 64), torch.float16)
    with pytest.raises(ValueError, match="not supported"):
        flash_attention_cuda(q, q, q)
    q = _randn(gen, (1, 2, 64, 16), torch.float32).transpose(2, 3)
    with pytest.raises(ValueError, match="unit-stride"):
        flash_attention_cuda(q, q, q)
    x = _randn(gen, (8, 64), torch.float32).t()           # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_cuda(x, torch.zeros(8, device="cuda"))


@pytest.mark.gpu
def test_serving_path_launches_the_kernels(gen):
    from repro_torch.configs.llama2_1b import SMOKE
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
                     dynamic_dims={"b": (1, 8), "s": (16, 128)}, device="cuda")
    for b, s in [(1, 16), (3, 96)]:
        tok = torch.randint(0, SMOKE.vocab, (b, s), generator=gen,
                            device="cuda", dtype=torch.int32)
        f0, n0 = flash_attention_cuda.launches, rmsnorm_cuda.launches
        got = opt(params, {"tokens": tok})
        assert flash_attention_cuda.launches - f0 == SMOKE.n_layers
        assert rmsnorm_cuda.launches - n0 == 2 * SMOKE.n_layers + 1
        st = opt.last_report.stats
        assert st.device_peak <= opt.guaranteed_peak_bytes
        assert st.arena_bytes <= opt.arena_bound_bytes
        torch.testing.assert_close(got, plain(params, {"tokens": tok}),
                                   rtol=2e-4, atol=2e-4)
