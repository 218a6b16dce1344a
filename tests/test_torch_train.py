"""The port's train step on the CPU, against the reference's, on the
reference's four bench archs (``llama2_1b``, ``gemma_2b``, ``granite_8b``,
``musicgen_medium``; musicgen's batch in the ``embeddings`` layout).

* ``optimize(make_train_step)`` of each smoke config against the
  JAX ``make_train_step`` on the same weights and AdamW state
  (``params_from_jax``, ``opt_state_from_jax``; moments drawn from a
  seed): loss and updated params within 2e-4, the moments within 2e-4
  relative (atol 2e-4 of each leaf's largest entry), and the
  gradients of the two losses within 2e-4;
* the capture: one flat graph (forward, backward and AdamW) with no
  guards and the declared dims as its only symbols; the VM's outputs
  equal an eager call of the step bit for bit;
* ``torch.autograd.gradcheck`` of both kernel ops' backward on the plain
  (``ref``) route, in float64, the flash op at MHA, GQA and MQA
  (gemma_2b's 4/1) heads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_smoke_config
from repro_torch.configs.llama2_1b import SMOKE
from repro_torch.core import optimize, spec_like
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import loss_fn, opt_state_from_jax, params_from_jax
from test_torch_bench_archs import BENCH_ARCHS, batch_specs

ENVS = [(1, 16), (2, 40), (3, 96)]
DYNAMIC_DIMS = {"b": (1, 8), "s": (16, 128)}
TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, and the suite's
    workers share the cores: oversubscribed, this module ran ~9x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch_np(cfg, b, s, seed):
    """A seeded batch in the config's input layout."""
    rng = np.random.RandomState(seed)
    if cfg.input_mode == "tokens":
        return {k: rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
                for k in ("tokens", "labels")}
    return {"frame_embed": rng.randn(b, s, cfg.d_model).astype(np.float32),
            "labels": rng.randint(0, cfg.vocab, (b, s, cfg.n_codebooks))
            .astype(np.int32)}


def _torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def _by_path(tree):
    return dict(pytree.tree_flatten_with_path(tree)[0])


def _assert_trees_close(got, want, scaled=False):
    """Leaves allclose at rtol = atol = TOL; ``scaled``: atol is TOL times
    the leaf's largest magnitude (the AdamW moments are ~1e-3 and ~1e-6,
    far below an absolute 2e-4)."""
    g, w = _by_path(got), _by_path(want)
    assert g.keys() == w.keys()
    for k in w:
        want_k = w[k].numpy()
        atol = TOL * float(np.abs(want_k).max()) if scaled else TOL
        np.testing.assert_allclose(g[k].numpy(), want_k, rtol=TOL,
                                   atol=atol, err_msg=str(k))


@pytest.fixture(scope="module", params=BENCH_ARCHS)
def reference(request):
    """The reference's smoke model of one bench arch, an AdamW state three
    steps old (moments drawn from a seed), and its train step and loss
    gradients per shape."""
    from repro.configs import get_smoke_config as jget_smoke_config
    from repro.launch.steps import make_train_step as jstep
    from repro.models import init_params
    from repro.models import loss_fn as jloss_fn
    from repro.optim import AdamWState

    arch = request.param
    jcfg = dataclasses.replace(jget_smoke_config(arch), scan_layers=False)
    params = init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)
    opt_state = AdamWState(
        step=jnp.asarray(3, jnp.int32),
        m=jax.tree.map(lambda p: jnp.asarray(
            1e-3 * rng.randn(*p.shape), jnp.float32), params),
        v=jax.tree.map(lambda p: jnp.asarray(
            1e-6 * rng.rand(*p.shape), jnp.float32), params))
    step = jstep(jcfg)

    @jax.jit
    def step_and_grads(p, o, batch):
        grads = jax.grad(lambda q: jloss_fn(jcfg, q, batch))(p)
        return step(p, o, batch), grads

    results = {}

    def run(b, s):
        if (b, s) not in results:
            nb = {k: jnp.asarray(v) for k, v in
                  _batch_np(jcfg, b, s, b * 1000 + s).items()}
            results[(b, s)] = jax.tree.map(
                np.asarray, step_and_grads(params, opt_state, nb))
        return results[(b, s)]
    return arch, params, opt_state, run


@pytest.fixture(scope="module")
def port(reference):
    arch, jparams, jopt, _ = reference
    cfg = get_smoke_config(arch)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    opt_state = opt_state_from_jax(jax.tree.map(np.asarray, jopt), cfg,
                                   device="cpu")
    opt = optimize(make_train_step(cfg), spec_like(params),
                   spec_like(opt_state), batch_specs(cfg),
                   dynamic_dims=DYNAMIC_DIMS, device="cpu")
    return cfg, opt, params, opt_state


def test_capture_is_one_flat_graph_without_guards(port):
    cfg, opt, _, _ = port
    g = opt.plan.graph
    assert opt.report.guards == []
    assert g.free_symbols() == {"b", "s"}
    names = [n.prim_name for n in g.nodes]
    assert names.count("repro_torch.flash_attention.default") == \
        cfg.n_layers
    assert names.count("repro_torch.rmsnorm.default") == \
        2 * cfg.n_layers + 1
    # backward: the token embedding's (frames enter without one)
    embed_bwd = "aten.embedding_dense_backward.default" in names
    assert embed_bwd == (cfg.input_mode == "tokens")
    assert "aten.sqrt.default" in names                       # AdamW
    assert len(g.nodes) > 1000


@pytest.mark.parametrize("b,s", ENVS)
def test_train_step_matches_reference(reference, port, b, s):
    cfg, opt, params, opt_state = port
    (jloss, jnew, jnew_opt), _ = reference[3](b, s)
    nb = _torch_batch(_batch_np(cfg, b, s, b * 1000 + s))
    loss, new, new_opt = opt(params, opt_state, nb)
    np.testing.assert_allclose(loss.numpy(), jloss, rtol=TOL, atol=TOL)
    _assert_trees_close(new, params_from_jax(jnew, cfg, "cpu"))
    want_opt = opt_state_from_jax(jnew_opt, cfg, "cpu")
    _assert_trees_close(new_opt.m, want_opt.m, scaled=True)
    _assert_trees_close(new_opt.v, want_opt.v, scaled=True)
    assert int(new_opt.step) == int(want_opt.step) == int(opt_state.step) + 1
    # the VM runs the same ops as an eager call of the step
    eager = make_train_step(cfg)(params, opt_state, nb)
    got = pytree.tree_leaves((loss, new, new_opt))
    assert all(torch.equal(x, y) for x, y in
               zip(got, pytree.tree_leaves(eager)))
    st = opt.last_report.stats
    assert 0 < st.device_peak <= opt.guaranteed_peak_bytes


@pytest.mark.parametrize("b,s", ENVS)
def test_gradients_match_reference(reference, port, b, s):
    cfg, _, params, _ = port
    _, jgrads = reference[3](b, s)
    leaves, tree = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss = loss_fn(cfg, pytree.tree_unflatten(leaves, tree),
                   _torch_batch(_batch_np(cfg, b, s, b * 1000 + s)))
    grads = pytree.tree_unflatten(list(torch.autograd.grad(loss, leaves)),
                                  tree)
    _assert_trees_close(grads, params_from_jax(jgrads, cfg, "cpu"))


def test_train_step_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="compression"):
        make_train_step(SMOKE, compress=True)
    with pytest.raises(NotImplementedError, match="accumulation"):
        make_train_step(SMOKE, grad_accum=2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)], ids=str)
def test_flash_attention_backward_gradcheck(causal, heads):
    hq, hkv = heads
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)
               for shape in ((2, hq, 5, 8), (2, hkv, 5, 8), (2, hkv, 5, 8)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, causal, None, "ref"),
        (q, k, v))


def test_rmsnorm_backward_gradcheck():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 16, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    scale = (0.1 * torch.randn(16, generator=gen, dtype=torch.float64)
             ).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, scale: ops.rmsnorm(x, scale, 1e-6, "ref"), (x, scale))
