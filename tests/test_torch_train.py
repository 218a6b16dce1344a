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


# -- gradient accumulation and compression (smoke llama2_1b, f32) ------------

OPTION_B = 4
OPTION_ENVS = [(4, 24), (4, 40)]


@pytest.fixture(scope="module")
def options():
    """The reference's smoke ``llama2_1b`` (``scan_layers=False``) with an
    AdamW state three steps old and a compression error drawn from a
    seed, its eager (jitted) ``grad_accum=2`` and ``compress=True`` steps
    per shape, and the same state in the port's layout
    (``models/convert.py``)."""
    from repro.configs import get_smoke_config as jget_smoke_config
    from repro.distributed.compression import CompressionState
    from repro.launch.steps import make_train_step as jstep
    from repro.models import init_params
    from repro.optim import AdamWState
    from repro_torch.models import comp_state_from_jax

    jcfg = dataclasses.replace(jget_smoke_config("llama2_1b"),
                               scan_layers=False)
    params = init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(11)
    opt_state = AdamWState(
        step=jnp.asarray(3, jnp.int32),
        m=jax.tree.map(lambda p: jnp.asarray(
            1e-3 * rng.randn(*p.shape), jnp.float32), params),
        v=jax.tree.map(lambda p: jnp.asarray(
            1e-6 * rng.rand(*p.shape), jnp.float32), params))
    comp = CompressionState(error=jax.tree.map(lambda p: jnp.asarray(
        1e-4 * rng.randn(*p.shape), jnp.float32), params))
    steps = {"grad_accum": jax.jit(jstep(jcfg, grad_accum=2)),
             "compress": jax.jit(jstep(jcfg, compress=True))}
    results = {}

    def run(option, b, s):
        if (option, b, s) not in results:
            nb = {k: jnp.asarray(v) for k, v in
                  _batch_np(jcfg, b, s, b * 100 + s).items()}
            state = (params, opt_state) + \
                ((comp,) if option == "compress" else ())
            results[(option, b, s)] = jax.tree.map(
                np.asarray, steps[option](*state, nb))
        return results[(option, b, s)]

    cfg = SMOKE
    np_tree = jax.tree.map(np.asarray, (params, opt_state, comp))
    port_state = (params_from_jax(np_tree[0], cfg, "cpu"),
                  opt_state_from_jax(np_tree[1], cfg, "cpu"),
                  comp_state_from_jax(np_tree[2], cfg, "cpu"))
    return jcfg, run, port_state, (params, opt_state, comp)


def _option_step(option):
    if option == "grad_accum":
        return make_train_step(SMOKE, grad_accum=2)
    return make_train_step(SMOKE, compress=True)


def _option_state(option, port_state):
    return port_state if option == "compress" else port_state[:2]


def _quant_step(port_state, nb) -> float:
    """The largest quantization step (a block's scale) of the compression
    the port's eager step makes from ``port_state``: max |g + err| / 127."""
    params, _, comp = port_state
    leaves, tree = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        grads = torch.autograd.grad(loss_fn(
            SMOKE, pytree.tree_unflatten(leaves, tree), nb), leaves)
    return max(float((g.float() + e).abs().max()) for g, e in
               zip(grads, pytree.tree_leaves(comp.error))) / 127


def _assert_close_up_to_flips(got, want, flip, scaled=False):
    """As ``_assert_trees_close``, but an element may also differ by
    ``flip`` (what one quantization step moves it by): where the two
    packages' f32 gradients straddle a rounding tie, q differs by one.
    Such elements stay rare: at most 0.1% of a leaf's, or one."""
    g, w = _by_path(got), _by_path(want)
    assert g.keys() == w.keys()
    for k in w:
        want_k, got_k = w[k].numpy(), g[k].numpy()
        atol = TOL * float(np.abs(want_k).max()) if scaled else TOL
        tol = atol + TOL * np.abs(want_k)
        diff = np.abs(got_k - want_k)
        assert (diff <= tol + flip).all(), str(k)
        assert int((diff > tol).sum()) <= max(1, want_k.size // 1000), \
            str(k)


@pytest.mark.parametrize("option", ["grad_accum", "compress"])
def test_option_steps_match_reference(options, option):
    """The port's eager steps against the reference's on the same weights,
    moments and compression error: loss, parameters, moments and the new
    error within 2e-4 (the moments relative to their leaf's largest); with
    compression, an element of the error and moments may also sit one
    quantization step apart, where the two gradients straddle a tie."""
    from repro_torch.models import comp_state_from_jax

    _, run, port_state, _ = options
    cfg = SMOKE
    for b, s in OPTION_ENVS:
        want = run(option, b, s)
        nb = _torch_batch(_batch_np(cfg, b, s, b * 100 + s))
        got = _option_step(option)(*_option_state(option, port_state), nb)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=TOL,
                                   atol=TOL)
        _assert_trees_close(got[1], params_from_jax(want[1], cfg, "cpu"))
        want_opt = opt_state_from_jax(want[2], cfg, "cpu")
        if option == "grad_accum":
            _assert_trees_close(got[2].m, want_opt.m, scaled=True)
            _assert_trees_close(got[2].v, want_opt.v, scaled=True)
            continue
        # AdamW's b1 = 0.9, b2 = 0.95: a step d moves m by 0.1 d and v by
        # 0.05 of the square's change, at most 0.05 d (2 |g_hat| + d)
        d = _quant_step(port_state, nb)
        g_max = 127 * d
        _assert_close_up_to_flips(got[2].m, want_opt.m, 0.1 * d * 1.001,
                                  scaled=True)
        _assert_close_up_to_flips(got[2].v, want_opt.v,
                                  0.05 * d * (2 * g_max + d) * 1.001,
                                  scaled=True)
        _assert_close_up_to_flips(got[3].error, comp_state_from_jax(
            want[3], cfg, "cpu").error, d * 1.001)


def test_quantize_int8_bitwise_to_reference():
    """Blocks of 256 with a ragged tail, a zero block (the 1e-12 floor),
    exact halves (round half to even) and the clip at 127."""
    from repro.distributed.compression import quantize_int8 as jquant
    from repro_torch.distributed import quantize_int8

    rng = np.random.RandomState(5)
    ties = np.zeros(512, np.float32)
    ties[:256] = np.arange(256) % 9 - 4.5      # max 4.5: ties at x.5
    ties[0] = 127.0                            # scale 1: ties stay ties
    cases = [rng.randn(1000).astype(np.float32),
             (rng.randn(33, 17) * 1e-9).astype(np.float32),
             np.zeros((3, 256), np.float32), ties,
             np.float32([1.0, -1.0, 0.5, 3e38, -3e38])]
    for x in cases:
        jq, js = jquant(jnp.asarray(x))
        q, scale = quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(js))


@pytest.fixture(scope="module")
def option_plans(options):
    from repro_torch.core import TensorSpec, symbolic_dims
    B, S = symbolic_dims("b, s")
    params = options[2]
    plans = {}
    for option in ("grad_accum", "compress"):
        b = OPTION_B if option == "grad_accum" else B
        spec = {k: TensorSpec((b, S), torch.int32)
                for k in ("tokens", "labels")}
        dims = {"s": DYNAMIC_DIMS["s"]} if option == "grad_accum" \
            else DYNAMIC_DIMS
        plans[option] = optimize(
            _option_step(option),
            *[spec_like(x) for x in _option_state(option, params)], spec,
            dynamic_dims=dims, device="cpu")
    return plans


def _seed_state():
    """The port's seed-0 smoke state: weights, AdamW and a zero error."""
    from repro_torch.distributed import init_compression_state
    from repro_torch.launch.steps import adamw_config_for
    from repro_torch.models import init_params
    from repro_torch.optim import init_state
    params = init_params(SMOKE, seed=0, device="cpu")
    return (params, init_state(params, adamw_config_for(SMOKE)),
            init_compression_state(params))


@pytest.mark.parametrize("option", ["grad_accum", "compress"])
def test_option_steps_through_optimize_are_eager(options, option_plans,
                                                 option):
    """One plan, no guard: every output bitwise equal to the eager step's;
    the compressed step twice, the second from the first's error."""
    opt = option_plans[option]
    assert opt.report.guards == []
    state = _option_state(option, options[2])
    for b, s in OPTION_ENVS:
        nb = _torch_batch(_batch_np(SMOKE, b, s, b * 100 + s))
        got = opt(*state, nb)
        want = _option_step(option)(*state, nb)
        assert all(torch.equal(x, y) for x, y in
                   zip(pytree.tree_leaves(got), pytree.tree_leaves(want)))
        assert 0 < opt.last_report.stats.device_peak <= \
            opt.guaranteed_peak_bytes
        if option == "compress":
            state = tuple(got[1:])


def test_reference_accum_plan_raises_where_the_port_runs(options,
                                                        option_plans):
    """The reference plans ``grad_accum=2`` (b static, s symbolic) and its
    first call raises; the port's plan runs (held bitwise above)."""
    import repro.core as R
    from repro.launch.steps import make_train_step as jstep

    jcfg, _, _, (params, opt_state, _) = options
    S, = R.symbolic_dims("s")
    spec = {k: jax.ShapeDtypeStruct((OPTION_B, S), jnp.int32)
            for k in ("tokens", "labels")}
    as_spec = lambda t: jax.tree.map(              # noqa: E731
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), t)
    jfn = R.optimize(jstep(jcfg, grad_accum=2), as_spec(params),
                     as_spec(opt_state), spec,
                     dynamic_dims={"s": DYNAMIC_DIMS["s"]})
    b, s = OPTION_ENVS[0]
    nb = {k: jnp.asarray(v) for k, v in
          _batch_np(jcfg, b, s, b * 100 + s).items()}
    with pytest.raises(Exception, match="UnexpectedDimVar|'s'"):
        jfn(params, opt_state, nb)


def test_compress_through_both_optimizes(options, option_plans):
    """``compress=True`` with (b, s) symbolic through the reference's
    ``optimize`` and the port's, on the same state: the loss, parameters
    and the new error within 2e-4, the error up to rare tie flips."""
    import repro.core as R
    from repro.launch.steps import make_train_step as jstep
    from repro_torch.models import comp_state_from_jax

    jcfg, _, port_state, jstate = options
    B, S = R.symbolic_dims("b, s")
    spec = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
            for k in ("tokens", "labels")}
    as_spec = lambda t: jax.tree.map(              # noqa: E731
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), t)
    jfn = R.optimize(jstep(jcfg, compress=True),
                     *[as_spec(x) for x in jstate], spec,
                     dynamic_dims=DYNAMIC_DIMS)
    opt = option_plans["compress"]
    for b, s in ((1, 16), (3, 40)):
        npb = _batch_np(jcfg, b, s, b * 100 + s)
        want = jax.tree.map(np.asarray, jfn(
            *jstate, {k: jnp.asarray(v) for k, v in npb.items()}))
        got = opt(*port_state, _torch_batch(npb))
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=TOL,
                                   atol=TOL)
        _assert_trees_close(got[1], params_from_jax(want[1], SMOKE, "cpu"))
        d = _quant_step(port_state, _torch_batch(npb))
        _assert_close_up_to_flips(got[3].error, comp_state_from_jax(
            want[3], SMOKE, "cpu").error, d * 1.001)


@pytest.mark.parametrize("case", ["indivisible", "symbolic_batch", "zero"])
def test_option_refusals(case):
    """``grad_accum`` must divide a static batch: an eager call at b = 3
    and a capture with ``b`` symbolic raise ``ValueError``, as does
    ``grad_accum=0``."""
    from repro_torch.core import TensorSpec, symbolic_dims
    if case == "zero":
        with pytest.raises(ValueError, match="grad_accum must be >= 1"):
            make_train_step(SMOKE, grad_accum=0)
        return
    params, opt_state, _ = _seed_state()
    if case == "indivisible":
        nb = _torch_batch(_batch_np(SMOKE, 3, 16, 0))
        with pytest.raises(ValueError, match="does not divide the batch"):
            make_train_step(SMOKE, grad_accum=2)(params, opt_state, nb)
        return
    B, S = symbolic_dims("b, s")
    spec = {k: TensorSpec((B, S), torch.int32) for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="grad_accum=2 .* symbolic"):
        optimize(make_train_step(SMOKE, grad_accum=2), spec_like(params),
                 spec_like(opt_state), spec, dynamic_dims=DYNAMIC_DIMS,
                 device="cpu")


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
