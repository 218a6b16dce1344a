"""The port's kernel ops against the reference's kernels.

On the CPU the ops run their plain PyTorch versions; those are held here
against the JAX kernels on the shapes of ``tests/test_kernels.py`` in f32
and bf16 (2e-4 / 5e-2): the Pallas kernel in interpret mode on two shapes
and ``repro.kernels.ref`` on the rest.  The hand-written CUDA kernels run
only on a card, where ``tests/test_torch_gpu.py`` holds them against the
plain versions.  What surrounds the bf16 flash kernel does run here: its
16-byte alignment check, and an emulation of its arithmetic (128-key
tiles, exp2, P in bf16 for P.V as the tensor cores take it) that shows
the card's bf16 tolerance holds by design.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import flash_attention as jflash
from repro.kernels.ops import rmsnorm as jrmsnorm
from repro_torch.kernels import (flash_attention, flash_attention_cuda,
                                 reference_attention, reference_rmsnorm,
                                 rmsnorm, rmsnorm_cuda)
from repro_torch.kernels.flash_attention import sm90_strides

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
FLASH_SHAPES = [  # (b, hq, hkv, s, hd) of tests/test_kernels.py:17-23
    (2, 4, 2, 256, 64), (1, 8, 1, 128, 128), (2, 4, 4, 100, 64),
    (1, 6, 2, 384, 32), (3, 2, 1, 64, 64)]
PALLAS_FLASH = {(2, 4, 4, 100, 64), (3, 2, 1, 64, 64)}
NORM_SHAPES = [(64, 256), (100, 300), (32, 2048), (7, 128), (2, 33, 160)]
PALLAS_NORM = {(100, 300), (7, 128)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_attention_matches_reference(shape, dtype):
    b, hq, hkv, s, hd = shape
    rng = np.random.RandomState(sum(shape))
    (jq, q), (jk, k), (jv, v) = (
        _pair(rng.randn(*dims).astype(np.float32), dtype)
        for dims in ((b, hq, s, hd), (b, hkv, s, hd), (b, hkv, s, hd)))
    if shape in PALLAS_FLASH:
        want = jflash(jq, jk, jv, causal=True, interpret=True)
    else:
        want = jref.reference_attention(jq, jk, jv, causal=True)
    got = flash_attention(q, k, v, True, None, None)
    assert got.dtype == q.dtype and tuple(got.shape) == (b, hq, s, hd)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_uneven_lengths_and_noncausal(causal):
    """S != T keeps the top-left causal alignment of the reference."""
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(*d).astype(np.float32)
               for d in ((1, 4, 48, 32), (1, 2, 80, 32), (1, 2, 80, 32)))
    want = jref.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    got = reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", NORM_SHAPES, ids=str)
def test_rmsnorm_matches_reference(shape, dtype):
    rng = np.random.RandomState(len(shape) + shape[-1])
    jx, x = _pair(rng.randn(*shape).astype(np.float32), dtype)
    js, sc = _pair((rng.randn(shape[-1]) * 0.1).astype(np.float32), dtype)
    if shape in PALLAS_NORM:
        want = jrmsnorm(jx, js, interpret=True)
    else:
        want = jref.reference_rmsnorm(jx, js)
    got = rmsnorm(x, sc, 1e-6, None)
    assert got.dtype == x.dtype and got.shape == x.shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_ops_dispatch_rules():
    q = torch.randn(1, 2, 8, 32)
    x = torch.randn(4, 16)
    sc = torch.zeros(16)
    # CPU tensors run the plain version; impl="ref" wins on any device
    torch.testing.assert_close(flash_attention(q, q, q, True, None, None),
                               reference_attention(q, q, q))
    torch.testing.assert_close(rmsnorm(x, sc, 1e-6, "ref"),
                               reference_rmsnorm(x, sc))
    for impl in ("pallas", "cuda"):
        with pytest.raises(ValueError, match="impl must be one of"):
            flash_attention(q, q, q, True, None, impl)
    # the CUDA wrappers refuse CPU tensors instead of falling back
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA device"):
        rmsnorm_cuda(x, sc)


@pytest.mark.parametrize("impl", [None, "ref"])
def test_attention_op_keeps_the_layout_of_q(impl):
    """(B, S, H, hd) activations go in transposed and come back in that
    layout, in the op and in its fake, so the model needs no copies."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 24, h, 32, generator=gen) for h in (4, 2, 2))
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), True, None, impl)
    assert got.stride() == q.transpose(1, 2).stride()
    torch.testing.assert_close(got, reference_attention(
        *(x.transpose(1, 2).contiguous() for x in (q, k, v))))
    with FakeTensorMode() as mode:
        fq = mode.from_tensor(q).transpose(1, 2)
        fk = mode.from_tensor(k).transpose(1, 2)
        fake = flash_attention(fq, fk, fk, True, None, impl)
    assert fake.stride() == got.stride()


def test_kernel_ops_capture_as_single_nodes():
    from torch.fx.experimental.proxy_tensor import make_fx

    def fn(q, x, s):
        return flash_attention(q, q, q, True, None, None), \
            rmsnorm(x, s, 1e-6, None)

    gm = make_fx(fn, tracing_mode="fake")(torch.randn(1, 2, 8, 32),
                                          torch.randn(4, 16), torch.zeros(16))
    targets = [str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"]
    assert targets == ["repro_torch.flash_attention.default",
                       "repro_torch.rmsnorm.default"]


ALIGNED = 0x7F3A_0000_0200  # a 16-byte aligned device address


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_sm90_strides_take_the_model_and_contiguous_layouts(hd):
    model = torch.empty(2, 100, 32, hd, dtype=torch.bfloat16).transpose(1, 2)
    dense = torch.empty(2, 32, 100, hd, dtype=torch.bfloat16)
    for x in (model, dense):
        assert sm90_strides("q", x.shape, x.stride(), ALIGNED, x.dtype) == \
            x.stride()[:3]
    # a dimension of size 1 is never stepped: its stride may be anything
    assert sm90_strides("q", (1, 1, 1, hd), (7, 5, 3, 1), ALIGNED,
                        torch.bfloat16) == (hd, hd, hd)


@pytest.mark.parametrize("case", ["pointer", "batch", "head", "row", "dtype"])
def test_sm90_strides_refuse_what_tma_cannot_address(case):
    shape, stride = (2, 4, 100, 64), [25600, 6400, 64, 1]
    ptr, dtype = ALIGNED, torch.bfloat16
    if case == "pointer":
        ptr += 2
    elif case == "dtype":
        dtype = torch.float32
    else:
        stride[("batch", "head", "row").index(case)] += 4   # 8 bytes off
    match = "bfloat16" if case == "dtype" else "16-byte"
    with pytest.raises(ValueError, match=match):
        sm90_strides("q", shape, stride, ptr, dtype)


def _emulate_sm90(q, k, v, causal, p_terms, block=128):
    """The bf16 kernel's arithmetic in plain torch: f32 scores over 128-key
    tiles, online softmax in the log2 domain with the finite -1e30 mask,
    row sums of the f32 probabilities, P in bf16 for P.V (one term, or the
    kernel's two: hi = bf16(P), lo = bf16(P - hi)), f32 accumulation, one
    rounding of the output."""
    b, h, s, hd = q.shape
    t = k.shape[2]
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, hd)
    rows = torch.arange(s)[:, None]
    for kv0 in range(0, t, block):
        cols = torch.arange(kv0, min(kv0 + block, t))[None, :]
        sc = qf @ kf[:, :, kv0:kv0 + block].transpose(-1, -2)
        if causal:
            sc = torch.where(cols <= rows, sc, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * scale_log2)
        p = torch.exp2(sc * scale_log2 - m_new * scale_log2)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        if p_terms == 2:
            hi = hi + (p - hi).to(torch.bfloat16).float()
        acc = acc * corr + hi @ vf[:, :, kv0:kv0 + block]
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("p_terms", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_arithmetic_holds_the_bf16_tolerance(causal, p_terms):
    """chip_smoke and the gpu tests hold the bf16 kernel to rtol = atol =
    1e-2 and a relative error norm of 1e-2; P in bf16 for the tensor cores
    stays inside both at the main path's width, as one term and as the
    kernel's two, which also rounds like the f32 softmax nearly always."""
    rng = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 1024, 128).astype(np.float32)
                                ).to(torch.bfloat16) for _ in range(3))
    got = _emulate_sm90(q, k, v, causal, p_terms)
    want = reference_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    d = got.float() - want.float()
    assert d.abs().max().item() <= 1e-2
    rel = (d.norm() / want.float().norm()).item()
    assert rel <= (1e-2 if p_terms == 1 else 2e-4)
    # the emulation is the JAX reference's function, not a near miss of it
    jwant = jref.reference_attention(*(jnp.asarray(x.float().numpy())
                                       for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(jwant), rtol=5e-2,
                               atol=5e-2)
