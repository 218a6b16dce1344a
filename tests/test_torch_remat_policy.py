"""The compiled path's activation checkpointing against the reference.

* ``recommend_policy`` (``core/remat/export.py``) on the smoke
  ``llama2_1b`` train step bridged into the port's IR
  (``test_torch_planning.bridge``): the reference's ``policy_name``,
  fractions and rationale at two envs and both headroom branches;
* the port's step with ``remat_policy`` ``"block"`` (each block under
  ``torch.utils.checkpoint``) and ``"none"``: loss and gradients bitwise
  equal, both within ``tests/test_kernels.py``'s f32 tolerance of the
  reference's ``jax.jit(make_train_step(cfg))`` at its defaults (its
  layer scan under ``jax.checkpoint``);
* ``graph_analysis``'s FLOPs of the captured ``block`` step minus the
  ``none`` step: exactly each layer's forward but the last FFN product;
* ``dots_saveable``: a backward that recomputes no ``aten.mm``, gradients
  bitwise the ``none`` ones;
* the xLSTM and hymba smoke train steps bitwise with and without any
  checkpointing (their mLSTM layers, mLSTM chunks and SSM chunks).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import repro.core.symbolic as R
import repro_torch.core.symbolic as P
from repro_torch.configs import get_smoke_config
from repro_torch.core import TensorSpec, optimize, spec_like, symbolic_dims
from repro_torch.core.remat import build_plan
from repro_torch.core.remat.export import dots_saveable, recommend_policy
from repro_torch.core.scheduling import schedule_graph as p_schedule
from repro_torch.launch.graph_analysis import analyze_graph
from repro_torch.launch.steps import make_train_step
from repro_torch.models import (init_params, loss_fn, opt_state_from_jax,
                                params_from_jax)
from repro_torch.models import lm, ssm, xlstm
from test_torch_planning import RANGES, bridge

TOL = 2e-4                  # tests/test_kernels.py:13, f32
ENVS = [{"b": 8, "s": 64}, {"b": 2, "s": 24}]
HEADROOMS = (0.25, 0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(cfg, b, s, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _grads(cfg, params, batch):
    """(loss, grads) of ``loss_fn`` taken eagerly, as the train step takes
    them."""
    leaves, tree = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss = loss_fn(cfg, pytree.tree_unflatten(leaves, tree), batch)
    return [loss.detach()] + list(torch.autograd.grad(loss, leaves))


def _bitwise(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# -- recommend_policy on bridged graphs ---------------------------------------


@pytest.fixture(scope="module")
def plans():
    """The reference's plan of its smoke ``llama2_1b`` train step
    (``memplan_bench``'s, ``scan_layers=False``) and the port's plan of the
    same graph bridged."""
    from benchmarks.memplan_bench import _step_and_specs
    from repro.core.ir import trace_to_graph
    from repro.core.remat.planner import build_plan as r_build_plan
    from repro.core.scheduling import schedule_graph as r_schedule

    step, args = _step_and_specs("llama2_1b")
    ref_graph, _ = trace_to_graph(step, *args)
    port_graph = bridge(ref_graph)
    for rn, pn in zip(ref_graph.nodes, port_graph.nodes):
        if rn.prim_name == "dot_general":
            (lc, _rc), _ = rn.params["dimension_numbers"]
            pn.params["contracting_dims"] = (0, tuple(lc))
    sg_r, sg_p = R.ShapeGraph(), P.ShapeGraph()
    R.declare_dim_ranges(sg_r, RANGES)
    P.declare_dim_ranges(sg_p, RANGES)
    return (r_build_plan(ref_graph, r_schedule(ref_graph, sg_r), sg_r),
            build_plan(port_graph, p_schedule(port_graph, sg_p), sg_p,
                       enable_remat=True))


@pytest.mark.parametrize("headroom", HEADROOMS)
@pytest.mark.parametrize("env", ENVS, ids=lambda e: f"b{e['b']}s{e['s']}")
def test_recommendation_equals_the_references(plans, env, headroom):
    from repro.core.remat.export import recommend_policy as ref_recommend
    r_plan, p_plan = plans
    want = ref_recommend(r_plan, env, memory_headroom=headroom)
    got = recommend_policy(p_plan, env, memory_headroom=headroom)
    assert got.policy_name == want.policy_name
    assert got.recompute_flop_fraction == want.recompute_flop_fraction
    assert got.recomputable_byte_fraction == want.recomputable_byte_fraction
    assert got.rationale == want.rationale
    assert (got.policy is None) == (want.policy is None)
    assert got.policy in (None, dots_saveable)


def test_both_headroom_branches_run(plans):
    """At these envs the regeneration is matmul-heavy: the headroom picks
    the policy, so both of its branches ran above."""
    _, p_plan = plans
    for env in ENVS:
        names = [recommend_policy(p_plan, env, memory_headroom=h).policy_name
                 for h in HEADROOMS]
        assert names == ["block", "dots_saveable"], (env, names)


# -- block against none: the step, the reference, the FLOPs -------------------


@pytest.fixture(scope="module")
def llama():
    """The reference's smoke ``llama2_1b`` at its defaults (scan, block
    remat), its weights and a three-step-old AdamW state carried over to
    the port, and the port's train step captured with symbolic (b, s) for
    each policy."""
    from repro.configs import get_smoke_config as jget_smoke_config
    from repro.models import init_params as jinit
    from repro.optim import AdamWState

    jcfg = jget_smoke_config("llama2_1b")
    assert jcfg.scan_layers and jcfg.remat_policy == "block"
    jparams = jinit(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)
    jopt = AdamWState(
        step=jnp.asarray(3, jnp.int32),
        m=jax.tree.map(lambda p: jnp.asarray(
            1e-3 * rng.randn(*p.shape), jnp.float32), jparams),
        v=jax.tree.map(lambda p: jnp.asarray(
            1e-6 * rng.rand(*p.shape), jnp.float32), jparams))
    cfg = get_smoke_config("llama2_1b")
    assert cfg.scan_layers and cfg.remat_policy == "block"
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    opt_state = opt_state_from_jax(jax.tree.map(np.asarray, jopt), cfg,
                                   "cpu")
    B, S = symbolic_dims("b, s")
    batch = {k: TensorSpec((B, S), torch.int32) for k in ("tokens", "labels")}
    steps = {pol: optimize(make_train_step(
                 dataclasses.replace(cfg, remat_policy=pol)),
                 spec_like(params), spec_like(opt_state), batch,
                 dynamic_dims={"b": (1, 8), "s": (16, 64)}, device="cpu")
             for pol in ("block", "none")}
    return jcfg, jparams, jopt, cfg, params, opt_state, steps


def _close(got, want, scaled=False):
    """Leaves of two trees, matched by path, allclose at rtol = atol = TOL
    (``scaled``: atol TOL times the leaf's largest magnitude)."""
    g = dict(pytree.tree_flatten_with_path(got)[0])
    w = dict(pytree.tree_flatten_with_path(want)[0])
    assert g.keys() == w.keys()
    for k, wk in w.items():
        wk = np.asarray(wk)
        atol = TOL * float(np.abs(wk).max()) if scaled else TOL
        np.testing.assert_allclose(np.asarray(g[k]), wk, rtol=TOL, atol=atol,
                                   err_msg=str(k))


@pytest.mark.parametrize("env", ENVS, ids=lambda e: f"b{e['b']}s{e['s']}")
def test_block_and_none_are_bitwise_and_match_the_reference(llama, env):
    from repro.launch.steps import make_train_step as jstep
    from repro.models import loss_fn as jloss_fn
    jcfg, jparams, jopt, cfg, params, opt_state, steps = llama
    nb = _tokens(cfg, env["b"], env["s"], env["b"] * 100 + env["s"])
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    grads = {pol: _grads(dataclasses.replace(cfg, remat_policy=pol),
                         params, batch) for pol in ("block", "none")}
    assert _bitwise(grads["block"], grads["none"])
    outs = {pol: fn(params, opt_state, batch) for pol, fn in steps.items()}
    assert _bitwise(pytree.tree_leaves(outs["block"]),
                    pytree.tree_leaves(outs["none"]))

    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, jb)))(jparams)
    leaves, tree = pytree.tree_flatten(params)
    np.testing.assert_allclose(grads["block"][0].numpy(), np.asarray(jloss),
                               rtol=TOL, atol=TOL)
    _close(pytree.tree_unflatten(grads["block"][1:], tree),
           params_from_jax(jax.tree.map(np.asarray, jg), cfg, "cpu"))
    jl, jnew, jnew_opt = jax.jit(jstep(jcfg))(jparams, jopt, jb)
    loss, new, new_opt = outs["block"]
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    _close(new, params_from_jax(jax.tree.map(np.asarray, jnew), cfg, "cpu"))
    want_opt = opt_state_from_jax(jax.tree.map(np.asarray, jnew_opt), cfg,
                                  "cpu")
    _close(new_opt.m, want_opt.m, scaled=True)
    _close(new_opt.v, want_opt.v, scaled=True)


@pytest.mark.parametrize("env", ENVS, ids=lambda e: f"b{e['b']}s{e['s']}")
def test_block_adds_exactly_the_recompute(llama, env):
    """Each layer's forward but the last FFN product, which nothing in the
    backward reads (``checkpoint`` stops its recompute at the last saved
    tensor): q, k, v, o, the gate and up products and the attention's QKᵀ
    and PV, a token and layer."""
    cfg, steps = llama[3], llama[6]
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, f, n = cfg.resolved_head_dim, cfg.d_ff, cfg.n_layers
    t = env["s"]
    per_token = 2 * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d
                     + 2 * d * f) + 4 * t * hq * hd
    flops = {pol: analyze_graph(fn.plan.graph, env)["flops"]
             for pol, fn in steps.items()}
    assert flops["block"] - flops["none"] == n * per_token * env["b"] * t


# -- dots_saveable --------------------------------------------------------------


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _counted_grads(cfg, params, batch):
    with _Count() as c:
        out = _grads(cfg, params, batch)
    return out, c.n


def test_dots_saveable_recomputes_no_mm(llama, monkeypatch):
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    cfg, params = llama[3], llama[4]
    batch = {k: torch.from_numpy(v) for k, v in _tokens(cfg, 2, 24, 5).items()}
    none, n_none = _counted_grads(
        dataclasses.replace(cfg, remat_policy="none"), params, batch)
    block, n_block = _counted_grads(cfg, params, batch)

    def selective(fn, *args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              dots_saveable), **kwargs)
    monkeypatch.setattr(lm, "checkpointed", selective)
    dots, n_dots = _counted_grads(cfg, params, batch)
    mm = torch.ops.aten.mm.default
    assert n_block[mm] > n_none[mm]                  # block recomputes them
    assert n_dots[mm] == n_none[mm]                  # dots_saveable saves them
    assert sum(n_dots.values()) > sum(n_none.values())   # the rest recomputed
    assert _bitwise(dots, none) and _bitwise(block, none)


# -- the other families ---------------------------------------------------------


@pytest.mark.parametrize("arch", ["xlstm_1p3b", "hymba_1p5b"])
def test_recurrent_families_are_bitwise_with_and_without_checkpoints(
        arch, monkeypatch):
    """The mLSTM layers (under ``remat_policy``) and the mLSTM and SSM
    chunks (always, as the reference's) recomputed, against the same step
    with no checkpoint at all, at a length of several chunks."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _tokens(cfg, 2, 40, 3).items()}
    got = {pol: _grads(dataclasses.replace(cfg, remat_policy=pol), params,
                       batch) for pol in ("block", "none")}
    with monkeypatch.context() as m:
        counted = []

        def plain(fn, *args, **kwargs):
            counted.append(fn.__name__)
            return fn(*args, **kwargs)
        for mod in (lm, ssm, xlstm):
            m.setattr(mod, "checkpointed", plain)
        bare = _grads(cfg, params, batch)
    assert len(set(counted)) >= 2, counted          # layers and chunks
    assert _bitwise(got["block"], bare) and _bitwise(got["none"], bare)
    assert all(torch.isfinite(g).all() for g in bare)


def test_no_checkpoint_without_grad(monkeypatch):
    """A forward without a gradient (prefill, decode, serve), under
    ``no_grad`` or with nothing that requires grad, calls the block
    plainly: its launches do not move."""
    cfg = get_smoke_config("llama2_1b")
    params = init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _tokens(cfg, 2, 16, 1).items()}
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        lm.forward(cfg, params, batch)
    lm.forward(cfg, params, batch)
    assert calls == []
    _grads(cfg, params, batch)
    assert len(calls) == cfg.n_layers


@pytest.mark.parametrize("arch", ["llama2_1b", "gemma_2b"])
def test_prefill_capture_is_the_flat_one(arch):
    """The prefill's plan captured at the defaults is the flat graph's,
    node for node."""
    from repro_torch.launch.steps import make_prefill_step
    cfg = get_smoke_config(arch)
    params = init_params(cfg, 0, device="cpu")
    B, S = symbolic_dims("b, s")
    stats = [optimize(make_prefill_step(c), spec_like(params),
                      {"tokens": TensorSpec((B, S), torch.int32)},
                      device="cpu").plan.graph.stats()
             for c in (cfg, dataclasses.replace(cfg, scan_layers=False))]
    assert stats[0] == stats[1]
