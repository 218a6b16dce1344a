"""The reference's four bench archs through the port's train step.

Port twins of ``benchmarks/memplan_bench.py``'s ``_step_and_specs`` and
``concretize_spec``, which the other port tests import:

* ``step_and_specs(arch)``: the smoke config's ``make_train_step`` and its
  argument specs with symbolic ``(b, s)``: ``tokens``/``labels`` (B, S)
  int32, or ``frame_embed`` (B, S, d_model) f32 with ``labels``
  (B, S, n_codebooks) int32; ``None`` for a ``vlm`` config, as the
  reference's;
* ``concretize(spec, env, rng)``: int leaves 1..6, float leaves
  ``rand * 0.02`` (positive: some leaves are second moments the step
  square-roots), from a ``numpy.random.RandomState``.

Held here: the specs equal the reference's, leaf for leaf; and the twin
of ``tests/test_lowering.py``'s
``test_differential_vm_vs_reference_on_bench_arch``: on every bench arch
the VM and the op-by-op interpreter of one plan agree bit for bit at
three envs, with equal ``device_peak``, ``arena_bytes`` and
``reuse_ratio``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_smoke_config
from repro_torch.core import TensorSpec, optimize, spec_like, symbolic_dims
from repro_torch.core.api import DynamicShapeFunction
from repro_torch.launch.steps import adamw_config_for, make_train_step
from repro_torch.models import init_params
from repro_torch.optim import init_state

BENCH_ARCHS = ["llama2_1b", "gemma_2b", "granite_8b", "musicgen_medium"]
PROBE_ENVS = [{"b": 1, "s": 16}, {"b": 2, "s": 40}, {"b": 3, "s": 96}]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch_specs(cfg):
    """The train batch's specs with symbolic ``(b, s)``, by input mode."""
    B, S = symbolic_dims("b, s")
    if cfg.input_mode == "tokens":
        return {"tokens": TensorSpec((B, S), torch.int32),
                "labels": TensorSpec((B, S), torch.int32)}
    return {"frame_embed": TensorSpec((B, S, cfg.d_model), torch.float32),
            "labels": TensorSpec((B, S, cfg.n_codebooks), torch.int32)}


def step_and_specs(arch):
    """Train step + symbolic ``(b, s)`` specs for one bench arch, or
    ``None`` for an input mode the reference's bench does not model."""
    cfg = dataclasses.replace(get_smoke_config(arch), scan_layers=False)
    if cfg.input_mode not in ("tokens", "embeddings"):
        return None
    params = init_params(cfg, seed=0, device="cpu")
    opt_state = init_state(params, adamw_config_for(cfg))
    return make_train_step(cfg), (spec_like(params), spec_like(opt_state),
                                  batch_specs(cfg))


def concretize(spec, env, rng):
    """A concrete CPU tensor for a (possibly symbolic) ``TensorSpec``."""
    shape = tuple(e.evaluate(env) for e in spec.dim_exprs())
    if spec.dtype.is_floating_point:
        return torch.from_numpy(rng.rand(*shape) * 0.02).to(spec.dtype)
    return torch.from_numpy(rng.randint(1, 7, shape)).to(spec.dtype)


@pytest.mark.parametrize("arch", BENCH_ARCHS + ["internvl2_2b"])
def test_specs_equal_the_references(arch):
    """The port's specs are the reference's, leaf for leaf: the params and
    moments as ``params_from_jax`` lays the reference's out, the batch as
    ``_step_and_specs`` declares it."""
    import jax
    from benchmarks.memplan_bench import _step_and_specs

    from repro_torch.models import opt_state_from_jax, params_from_jax

    ours, ref = step_and_specs(arch), _step_and_specs(arch)
    assert (ours is None) == (ref is None)
    if ref is None:
        return
    cfg = get_smoke_config(arch)
    (jp, jo, jbatch), (p, o, batch) = ref[1], ours[1]

    def zeros(s):
        return np.zeros(s.shape, s.dtype)
    want_p = params_from_jax(jax.tree.map(zeros, jp), cfg, device="cpu")
    want_o = opt_state_from_jax(jax.tree.map(zeros, jo), cfg, device="cpu")
    for got, want in ((p, want_p), (o, want_o)):
        g = pytree.tree_flatten_with_path(got)[0]
        w = pytree.tree_flatten_with_path(spec_like(want))[0]
        assert len(g) == len(w)
        assert dict(g) == dict(w)
    assert batch.keys() == jbatch.keys()
    for k, s in batch.items():
        assert tuple(map(str, s.shape)) == tuple(map(str, jbatch[k].shape))
        assert str(s.dtype).split(".")[1] == jbatch[k].dtype.name


@pytest.mark.parametrize("arch", BENCH_ARCHS)
def test_differential_vm_vs_reference_on_bench_arch(arch):
    """VM and reference interpreter agree bitwise on every bench arch at
    three probe envs, with the same per-op memory accounting."""
    r = step_and_specs(arch)
    assert r is not None, f"{arch} missing from the bench arch set"
    step, args = r
    fn = optimize(step, *args, dynamic_dims={"b": (1, 8), "s": (8, 128)},
                  device="cpu")
    assert fn.program is not None and fn.report.guards == []
    ref = DynamicShapeFunction(fn.plan, fn.report, device=fn.device,
                               executor="reference")
    flat_specs, tree = pytree.tree_flatten(args)
    rng = np.random.RandomState(0)
    for env in PROBE_ENVS:
        flat = [concretize(s, env, rng) for s in flat_specs]
        outs_vm = fn(*pytree.tree_unflatten(flat, tree))
        rep_vm = fn.last_report
        outs_ref = ref(*pytree.tree_unflatten(flat, tree))
        rep_ref = ref.last_report
        got, want = pytree.tree_leaves(outs_vm), pytree.tree_leaves(outs_ref)
        assert len(got) == len(want)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), \
            "executors disagree bitwise"
        assert torch.isfinite(got[0])
        assert rep_vm.env == env and rep_ref.env == env
        assert rep_vm.stats.device_peak == rep_ref.stats.device_peak
        assert rep_vm.stats.arena_bytes == rep_ref.stats.arena_bytes
        assert rep_vm.stats.reuse_ratio == rep_ref.stats.reuse_ratio
