"""The port's serving slice end to end on the CPU, against the reference.

* ``optimize(prefill)`` of the smoke ``llama2_1b`` against the JAX
  ``prefill`` on the same weights (``params_from_jax``), and the port's
  ``forward`` against the JAX ``forward`` on the full logits;
* the plan's memory contract (device peak <= guaranteed peak, arena <=
  its bound) and one plan for every shape, ``b=1`` included;
* on the kernel_bench step (one node per kernel in both packages) the
  memory numbers must equal the reference's exactly;
* ``import repro_torch`` loads neither ``jax`` nor ``repro``.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs.llama2_1b import SMOKE
from repro_torch.core import TensorSpec, optimize, spec_like, symbolic_dims
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import forward, params_from_jax

ENVS = [(1, 16), (2, 40), (3, 96)]
DYNAMIC_DIMS = {"b": (1, 8), "s": (16, 128)}
TOL = 2e-4


@pytest.fixture(scope="module")
def weights():
    from repro.configs.llama2_1b import SMOKE as JSMOKE
    from repro.models import init_params
    jcfg = dataclasses.replace(JSMOKE, scan_layers=False)
    jparams = init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, params_from_jax(np_params, SMOKE, device="cpu")


@pytest.fixture(scope="module")
def served(weights):
    _, _, params = weights
    B, S = symbolic_dims("b, s")
    opt = optimize(make_prefill_step(SMOKE), spec_like(params),
                   {"tokens": TensorSpec((B, S), torch.int32)},
                   dynamic_dims=DYNAMIC_DIMS, device="cpu")
    return opt


def _tokens(b, s):
    return np.random.RandomState(b * 1000 + s).randint(
        0, SMOKE.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("b,s", ENVS)
def test_prefill_matches_reference(weights, served, b, s):
    from repro.models import prefill
    jcfg, jparams, params = weights
    tok = _tokens(b, s)
    want = np.asarray(prefill(jcfg, jparams, {"tokens": jnp.asarray(tok)}))
    got = served(params, {"tokens": torch.from_numpy(tok)})
    assert tuple(got.shape) == (b, SMOKE.vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # the VM runs the same ops as an eager call of the step
    eager = make_prefill_step(SMOKE)(params, {"tokens": torch.from_numpy(tok)})
    assert torch.equal(got, eager)
    st = served.last_report.stats
    assert 0 < st.device_peak <= served.guaranteed_peak_bytes
    assert 0 < st.arena_bytes <= served.arena_bound_bytes


@pytest.mark.parametrize("b,s", ENVS)
def test_forward_matches_reference(weights, b, s):
    from repro.models import forward as jforward
    jcfg, jparams, params = weights
    tok = _tokens(b, s)
    want, _ = jforward(jcfg, jparams, {"tokens": jnp.asarray(tok)})
    got = forward(SMOKE, params, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_one_plan_serves_every_shape(weights, served):
    """One capture covers the declared ranges, b=1 and odd s included."""
    _, _, params = weights
    program = served.program
    assert served.report.guards == []
    assert served.plan.graph.free_symbols() == {"b", "s"}
    for b, s in [(1, 17), (8, 128), (5, 16)]:
        out = served(params, {"tokens": torch.from_numpy(_tokens(b, s))})
        assert tuple(out.shape) == (b, SMOKE.vocab)
        assert served.program is program
        assert served.last_report.env == {"b": b, "s": s}
    with pytest.raises(ValueError, match="outside its declared range"):
        served(params, {"tokens": torch.zeros(9, 16, dtype=torch.int32)})


def test_views_carry_no_bytes_and_keep_their_base_live(served):
    g = served.plan.graph
    views = [v for v in g.values if v.base is not None]
    assert views and all(v.nbytes_expr == 0 for v in views)
    for v in views:
        assert v.base.base is None          # the root owns the storage
        for n in v.consumers:
            assert v.base in n.invals       # ... and outlives every reader
    # the returned last-position logits own their bytes
    assert all(v.base is None for v in g.outputs)


@pytest.mark.parametrize("knobs", [
    dict(donate_inputs=True), dict(count_inputs=False),
    dict(memory_plan="none"), dict(enable_scheduling=False),
    dict(donate_inputs=True, count_inputs=False)], ids=str)
def test_optimize_knobs_keep_outputs_and_bounds(weights, knobs):
    _, _, params = weights
    B, S = symbolic_dims("b, s")
    opt = optimize(make_prefill_step(SMOKE), spec_like(params),
                   {"tokens": TensorSpec((B, S), torch.int32)},
                   dynamic_dims=DYNAMIC_DIMS, device="cpu", **knobs)
    batch = {"tokens": torch.from_numpy(_tokens(2, 40))}
    assert torch.equal(opt(params, batch),
                       make_prefill_step(SMOKE)(params, batch))
    st = opt.last_report.stats
    assert st.device_peak <= opt.guaranteed_peak_bytes
    if knobs.get("memory_plan") == "none":
        assert opt.arena_bound_bytes is None and st.arena_bytes == 0
    else:
        assert st.arena_bytes <= opt.arena_bound_bytes
    assert (opt.program.counts()["Donate"] > 0) == \
        bool(knobs.get("donate_inputs"))


def test_optimize_refuses_what_is_not_ported(weights):
    _, _, params = weights
    B, S = symbolic_dims("b, s")
    args = (spec_like(params), {"tokens": TensorSpec((B, S), torch.int32)})
    # bucketed dispatch is ported: buckets= builds a specialization table
    opt = optimize(make_prefill_step(SMOKE), *args, device="cpu",
                   dynamic_dims=DYNAMIC_DIMS, buckets="geometric")
    assert opt.specialization_table.n_buckets == 16
    with pytest.raises(ValueError, match="dynamic_dims"):
        optimize(make_prefill_step(SMOKE), *args, device="cpu",
                 buckets="geometric")
    with pytest.raises(TypeError, match="unexpected"):
        optimize(make_prefill_step(SMOKE), *args, device="cpu", bogus=1)
    with pytest.raises(ValueError, match="not symbolic dims"):
        optimize(make_prefill_step(SMOKE), *args, device="cpu",
                 dynamic_dims={"x": (1, 2)})


def test_optimize_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = TensorSpec((4,), torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize(lambda x: x * 2, spec)


# -- the kernel_bench step: one node per kernel in both packages --------------

KB_RANGES = {"b": (1, 16), "s": (1, 2048)}       # kernel_bench's ranges
KB_ENVS = [{"b": 4, "s": 32}, {"b": 2, "s": 256}, {"b": 1, "s": 1},
           {"b": 16, "s": 2048}]


def _kb_shapes(B, S, geo):
    return ((B, geo["hq"], S, geo["hd"]), (B, geo["hkv"], S, geo["hd"]),
            (B, geo["hkv"], S, geo["hd"]), (B, S, geo["d"]), (geo["d"],))


def _port_kb_fwd(q, k, v, x, scale):
    from repro_torch.kernels import flash_attention, rmsnorm
    return flash_attention(q, k, v, True, None, None), \
        rmsnorm(x, scale, 1e-6, None)


def _kb_plans(**knobs):
    """The kernel_bench step optimized by the reference and by the port."""
    from benchmarks.kernel_bench import _geometry, _make_fwd
    from repro.core import optimize as joptimize
    from repro.core import symbolic_dims as jdims

    geo = _geometry("llama2_1b")
    ref = joptimize(_make_fwd(None),
                    *[jax.ShapeDtypeStruct(sh, jnp.float32)
                      for sh in _kb_shapes(*jdims("b, s"), geo)],
                    dynamic_dims=KB_RANGES, **knobs)
    port = optimize(_port_kb_fwd,
                    *[TensorSpec(sh, torch.float32)
                      for sh in _kb_shapes(*symbolic_dims("b, s"), geo)],
                    dynamic_dims=KB_RANGES, device="cpu", **knobs)
    return ref, port, geo


@pytest.fixture(scope="module")
def kernel_step():
    return _kb_plans()


def test_kernel_step_has_one_node_per_kernel(kernel_step):
    ref, port, _ = kernel_step
    assert [n.prim_name for n in ref.plan.graph.nodes] == \
        ["flash_attention", "rmsnorm"]
    assert [n.prim_name for n in port.plan.graph.nodes] == \
        ["repro_torch.flash_attention.default", "repro_torch.rmsnorm.default"]


def test_kernel_step_bounds_equal_reference(kernel_step):
    ref, port, _ = kernel_step
    assert port.guaranteed_peak_bytes == ref.guaranteed_peak_bytes
    assert port.arena_bound_bytes == ref.arena_bound_bytes
    assert port.guaranteed_peak_bytes is not None


@pytest.mark.parametrize("env", KB_ENVS, ids=lambda e: f"b{e['b']}s{e['s']}")
def test_kernel_step_memory_equals_reference(kernel_step, env):
    ref, port, geo = kernel_step
    r = ref.program.resolve(env).stats_template
    p = port.program.resolve(env).stats_template
    assert (p.device_peak, p.arena_bytes) == (r.device_peak, r.arena_bytes)
    b, s = env["b"], env["s"]
    if b * s <= 512:   # run the small envs through the port's VM
        rng = np.random.RandomState(0)
        port(*[torch.from_numpy(rng.randn(*sh).astype(np.float32))
               for sh in _kb_shapes(b, s, geo)])
        st = port.last_report.stats
        assert (st.device_peak, st.arena_bytes) == \
            (r.device_peak, r.arena_bytes)


@pytest.mark.parametrize("knobs", [dict(donate_inputs=True),
                                   dict(count_inputs=False)], ids=str)
def test_kernel_step_knobs_match_reference(knobs):
    """Donation and uncounted inputs change the plan identically in both."""
    ref, port, _ = _kb_plans(**knobs)
    assert port.guaranteed_peak_bytes == ref.guaranteed_peak_bytes
    assert port.arena_bound_bytes == ref.arena_bound_bytes
    for env in KB_ENVS:
        r = ref.program.resolve(env).stats_template
        p = port.program.resolve(env).stats_template
        assert (p.device_peak, p.arena_bytes, p.donated_reuses) == \
            (r.device_peak, r.arena_bytes, r.donated_reuses)


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "import repro_torch.core.dispatch, repro_torch.launch.serve\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    import os
    from pathlib import Path

    import repro_torch
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                 if p]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20
