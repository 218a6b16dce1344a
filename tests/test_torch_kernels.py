"""The port's kernel ops against the reference's kernels.

On the CPU the ops run their plain PyTorch versions; those are held here
against the JAX kernels on the shapes of ``tests/test_kernels.py`` in f32
and bf16 (2e-4 / 5e-2): the Pallas kernel in interpret mode on two shapes
and ``repro.kernels.ref`` on the rest.  The hand-written CUDA kernels run
only on a card, where ``tests/test_torch_gpu.py`` holds them against the
plain versions.  What surrounds the flash kernels does run here: the
sm90 kernel's 16-byte alignment check and the mma kernel's copy width,
and emulations of both kernels' arithmetic (their key tiles, exp2, P in
bf16 for P.V as the tensor cores take it; f32 as 3xTF32 products) that
show the card's tolerances hold by design, and that one TF32 product a
product would not.
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
# 3 rows at every width a config normalizes (d_model; MLA's latents)
NORM_SHAPES += [(3, d) for d in (512, 1536, 2048, 3072, 4096, 4608, 7168)]
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


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
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
    """The bf16 kernel's arithmetic in plain torch: f32 scores over
    ``block``-key tiles (128, or 64 at hd 256), online softmax in the log2 domain with the finite -1e30 mask,
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


# (causal, p_terms, hd): the kernel's hd-128 instance (128-key tiles) with
# P as one bf16 term and as the kernel's two, and its hd-256 one (64-key
# tiles; gemma's head dim) as the kernel computes it, with two
SM90_CASES = [pytest.param(c, p, 128, id=f"{c}-{p}")
              for p in (1, 2) for c in (True, False)] + \
    [pytest.param(c, 2, 256, id=f"{c}-2-hd256") for c in (True, False)]


@pytest.mark.parametrize("causal,p_terms,hd", SM90_CASES)
def test_sm90_arithmetic_holds_the_bf16_tolerance(causal, p_terms, hd):
    """chip_smoke and the gpu tests hold the bf16 kernel to rtol = atol =
    1e-2 and a relative error norm of 1e-2; P in bf16 for the tensor cores
    stays inside both at the main path's width, as one term and as the
    kernel's two, which also rounds like the f32 softmax nearly always."""
    rng = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 1024, hd).astype(np.float32)
                                ).to(torch.bfloat16) for _ in range(3))
    got = _emulate_sm90(q, k, v, causal, p_terms,
                        block=128 if hd <= 128 else 64)
    want = reference_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    d = got.float() - want.float()
    assert d.abs().max().item() <= 1e-2
    rel = (d.norm() / want.float().norm()).item()
    assert rel <= (1e-2 if p_terms == 1 else 2e-4)
    if hd == 256 and causal:
        # why the kernel keeps two terms: with one, an output moves past
        # 1e-2 here (0.0156 against the two terms' 0.0039)
        one = _emulate_sm90(q, k, v, causal, 1, block=64)
        assert (one.float() - want.float()).abs().max().item() > 1e-2
    # the emulation is the JAX reference's function, not a near miss of it
    jwant = jref.reference_attention(*(jnp.asarray(x.float().numpy())
                                       for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(jwant), rtol=5e-2,
                               atol=5e-2)


# -- the mma kernel (csrc/flash_attention_mma.cu): f32 as 3xTF32, bf16 ------


def _tf32(x):
    """An f32 value as the tensor core reads it as TF32, and the kernel's
    big part (``split_tf32``): 10 mantissa bits, the low 13 bits of the
    bit pattern cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, terms):
    """``a @ b`` as the f32 kernel takes it: each operand split into big =
    TF32(x) and small = x - big, read by the tensor core as TF32, and
    big.big + big.small + small.big (``terms`` 3) or big.big alone (1),
    each product summed in f32."""
    a_big, b_big = _tf32(a), _tf32(b)
    out = a_big @ b_big
    if terms == 3:
        out = out + (a_big @ _tf32(b - b_big) + _tf32(a - a_big) @ b_big)
    return out


def _emulate_mma(q, k, v, causal, dtype, block, terms=3):
    """The mma kernel's arithmetic in plain torch: ``block``-key tiles, an
    online softmax in the log2 domain with the finite -1e30 mask and f32
    m, l and acc; in float32 both products as 3xTF32 (``terms`` 1: one
    TF32 product), in bfloat16 exact products summed in f32 with P taken
    as two bf16 terms, hi = bf16(P) and lo = bf16(P - hi); one rounding
    of the output to ``dtype``."""
    b, h, s, hd = q.shape
    t, group = k.shape[2], h // k.shape[1]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(group, dim=1) for x in (k, v))
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, hd)
    rows = torch.arange(s)[:, None]
    for kv0 in range(0, t, block):
        kt, vt = kf[:, :, kv0:kv0 + block], vf[:, :, kv0:kv0 + block]
        cols = torch.arange(kv0, kv0 + kt.shape[2])[None, :]
        if dtype == torch.float32:
            sc = _tf32_matmul(qf, kt.transpose(-1, -2), terms)
        else:
            sc = qf @ kt.transpose(-1, -2)
        x = sc * scale_log2
        if causal:
            x = torch.where(cols <= rows, x, torch.tensor(-1e30))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        if dtype == torch.float32:
            pv = _tf32_matmul(p, vt, terms)
        else:
            hi = p.to(torch.bfloat16).float()
            pv = hi @ vt + (p - hi).to(torch.bfloat16).float() @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(dtype)


def _mma_block(dtype, hd):
    """The key tile of the mma instance that runs ``hd`` in ``dtype``."""
    from repro_torch.kernels import variants as V
    variant = V.MMA_F32 if dtype == torch.float32 else V.MMA_BF16
    return V.variant_block(variant, {"hd": hd})["block_kv"]


def _hold_mma(got, q, k, v, causal):
    """The card's tolerances: f32 2e-4; bf16 1e-2 elementwise and 2e-4 in
    relative norm; against the port's plain version and the JAX
    reference's."""
    tol = 2e-4 if q.dtype == torch.float32 else 1e-2
    want = reference_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    d = got.float() - want.float()
    assert (d.norm() / want.float().norm()).item() <= 2e-4
    jwant = jref.reference_attention(*(jnp.asarray(x.float().numpy())
                                       for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(jwant), rtol=tol,
                               atol=tol)


MMA_HDS = (12, 16, 48, 128, 256)   # instances 16, 16, 48, 128, 256


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", MMA_HDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mma_arithmetic_holds_the_card_tolerance(dtype, hd, causal):
    """The mma kernel's arithmetic at the main path's length (S = T =
    1024, GQA 2/1) with each instance's key tile: inside the tolerances
    chip_smoke and the gpu tests hold the kernel to.  (bf16 at hd 128 and
    256 runs on the sm90 kernel; the mma kernel's 128 and 256 instances
    serve the bf16 head dims between, with this arithmetic.)"""
    tdt = DTYPES[dtype][1]
    rng = np.random.RandomState(hd + 7 * causal)
    q = torch.from_numpy(rng.randn(1, 2, 1024, hd).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(1, 1, 1024, hd).astype(np.float32))
            for _ in range(2))
    q, k, v = (x.to(tdt) for x in (q, k, v))
    got = _emulate_mma(q, k, v, causal, tdt, _mma_block(tdt, hd))
    _hold_mma(got, q, k, v, causal)


MMA_EDGE_SHAPES = [  # (b, hq, hkv, s, t): one row, ragged T, S < T, S > T
    (1, 4, 2, 1, 1), (2, 2, 1, 100, 100), (1, 4, 2, 100, 160),
    (1, 2, 2, 70, 33)]


@pytest.mark.parametrize("shape", MMA_EDGE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mma_arithmetic_at_one_row_a_ragged_t_and_s_not_t(dtype, shape):
    b, hq, hkv, s, t = shape
    tdt = DTYPES[dtype][1]
    rng = np.random.RandomState(s + t)
    for hd in MMA_HDS:
        q = torch.from_numpy(rng.randn(b, hq, s, hd).astype(np.float32))
        k, v = (torch.from_numpy(rng.randn(b, hkv, t, hd).astype(np.float32))
                for _ in range(2))
        q, k, v = (x.to(tdt) for x in (q, k, v))
        for causal in (True, False):
            got = _emulate_mma(q, k, v, causal, tdt, _mma_block(tdt, hd))
            _hold_mma(got, q, k, v, causal)


def test_one_tf32_product_misses_2e4_so_the_kernel_takes_three():
    """TF32 keeps 10 mantissa bits: one product a product moves f32
    attention past the 2e-4 the f32 route is held to; three do not."""
    x = torch.tensor([1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11), 3.0])
    assert _tf32(x).tolist() == [1 + 2 ** -10, -1.0, 3.0]
    rng = np.random.RandomState(21)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 1024, 128).astype(np.float32))
               for _ in range(3))
    want = reference_attention(q, k, v, causal=True)
    block = _mma_block(torch.float32, 128)
    single = _emulate_mma(q, k, v, True, torch.float32, block, terms=1)
    assert (single - want).abs().max().item() > 2e-4
    triple = _emulate_mma(q, k, v, True, torch.float32, block)
    assert (triple - want).abs().max().item() <= 2e-5


# (hd, dtype, layout, pointer offset in elements) -> the cp.async width
COPY_WIDTH_CASES = [
    ((12, torch.bfloat16, "dense", 0), 8),    # 24-byte rows: 3 x 8 bytes
    ((12, torch.bfloat16, "model", 0), 8),    # (B, S, 6, 12) transposed
    ((13, torch.bfloat16, "dense", 0), 0),    # 26-byte rows: plain loads
    ((16, torch.bfloat16, "dense", 1), 0),    # pointer 2 bytes off
    ((48, torch.bfloat16, "dense", 4), 8),    # pointer 8 bytes off
    ((16, torch.float32, "dense", 1), 4),     # pointer 4 bytes off
    ((12, torch.float32, "dense", 0), 16),    # 48-byte rows
    ((13, torch.float32, "model", 0), 4),     # 52-byte rows
    ((128, torch.float32, "one row", 0), 16),  # strides of size-1 dims unused
]


@pytest.mark.parametrize("case,want", COPY_WIDTH_CASES, ids=str)
def test_mma_copy_width_follows_rows_strides_and_pointers(case, want):
    from repro_torch.kernels.flash_attention import mma_copy_width
    hd, dtype, layout, off = case
    if layout == "model":
        x = torch.empty(2, 100, 6, hd, dtype=dtype).transpose(1, 2)
    elif layout == "one row":
        x = torch.empty(1, 1, 1, 3 * hd + 1, dtype=dtype)[..., :hd]
    else:
        x = torch.empty(2, 6, 100, hd, dtype=dtype)
    ptr = ALIGNED + off * dtype.itemsize
    assert mma_copy_width(hd, dtype.itemsize,
                          [(x.shape, x.stride(), ptr)] * 3) == want
