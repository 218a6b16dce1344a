"""The port's kernel ops against the reference's kernels.

On the CPU the ops run their plain PyTorch versions; those are held here
against the JAX kernels on the shapes of ``tests/test_kernels.py`` in f32
and bf16 (2e-4 / 5e-2): the Pallas kernel in interpret mode on two shapes
and ``repro.kernels.ref`` on the rest.  The hand-written CUDA kernels run
only on a card, where ``tests/test_torch_gpu.py`` holds them against the
plain versions.
"""
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
