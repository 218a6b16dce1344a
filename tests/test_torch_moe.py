"""The MoE family on the port against the reference, on the CPU.

``kimi_k2_1t_a32b`` (GQA + 384-expert MoE) and ``deepseek_v3_671b`` (MLA
+ 256-expert MoE), their smoke configs in f32, weights through
``params_from_jax``:

* the configs and ``param_count`` (``active_only`` too) equal the
  reference's;
* ``moe_apply`` equals the reference's output and aux loss, and routes
  exactly as it does: the dispatch slots ``dest`` and their tokens
  ``token_of``, recorded from inside the reference's own dispatch, are
  equal, so the same (token, choice) pairs drop; identical tokens at
  ``moe_capacity=1.0`` make the drops depend on the stable sort;
* ``mla_prefill`` (with and without the query latent) and the absorbed
  ``mla_decode`` from a mid-stream latent cache;
* ``forward`` (logits and aux), ``prefill`` and ``loss_fn``;
* ``decode_step`` from a mid-stream cache (``cache_from_jax``, an
  ``MLACache`` for deepseek), and decode over a prompt equal to the
  forward at a no-drop capacity (the reference's measure);
* ``serve``: the reference's generation test for both archs, greedy
  determinism, and its tokens equal to the reference's decode loop run on
  the port's weights;
* eager gradients of ``loss_fn`` against ``jax.value_and_grad`` (the
  twin of ``tests/test_models.py``'s capacity-drop test);
* ``optimize`` refuses a symbolic ``(b, s)`` at capture, where the
  reference stops at the capacity ``round(s k cf / E)``; with ``b``
  alone the port's plan equals the eager prefill at every ``b``.

Inputs are made with numpy from a seed; f32 is held to 2e-4.
"""
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core import optimize, spec_like, symbolic_dims
from repro_torch.launch.serve import serve
from repro_torch.launch.specs import batch_specs
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import (cache_from_jax, decode_step, forward,
                                forward_aux, init_cache, init_params,
                                loss_fn, params_from_jax, prefill)
from repro_torch.models.ffn import capacity, moe_apply, moe_route
from repro_torch.models.mla import (MLACache, MLAConfig, mla_decode,
                                    mla_prefill)

TOL = 2e-4
MOE_ARCHS = ["kimi_k2_1t_a32b", "deepseek_v3_671b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _jax_cfg(cfg):
    """The reference's smoke config of the same name, at cfg's capacity."""
    from repro.configs import get_smoke_config as jget
    ref = jget({"kimi-smoke": "kimi_k2_1t_a32b",
                "deepseek-smoke": "deepseek_v3_671b"}[cfg.name])
    return dataclasses.replace(ref, moe_capacity=cfg.moe_capacity)


def _weights(cfg, seed=0):
    """Reference weights (jax) and the port's copy of them."""
    from repro.models import init_params as jinit
    jcfg = _jax_cfg(cfg)
    jparams = jinit(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab,
                                               (b, s)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_configs_equal_the_reference(arch, which):
    import importlib
    ref = getattr(importlib.import_module(f"repro.configs.{arch}"), which)
    port = getattr(importlib.import_module(f"repro_torch.configs.{arch}"),
                   which)
    shared = {f.name for f in dataclasses.fields(port)} & \
        {f.name for f in dataclasses.fields(ref)}
    assert {"n_experts", "top_k", "n_shared", "moe_capacity", "attn_kind",
            "qk_nope", "qk_rope", "v_dim", "r_kv", "r_q"} <= shared
    assert {n: getattr(port, n) for n in shared} == \
        {n: getattr(ref, n) for n in shared}
    assert port.param_count() == ref.param_count()
    assert port.param_count(active_only=True) == \
        ref.param_count(active_only=True)
    assert arch in ARCHS
    if port.attn_kind == "mla":
        assert port.mla_config()._asdict() == ref.mla_config()._asdict()
    if (arch, which) == ("deepseek_v3_671b", "CONFIG"):
        # tests/test_models.py's test_param_count_sane
        assert 6.0e11 < port.param_count() < 7.5e11
        assert 3.0e10 < port.param_count(active_only=True) < 5.0e10
    if (arch, which) == ("kimi_k2_1t_a32b", "CONFIG"):
        assert port.resolved_head_dim == 112


# -- the MoE layer ----------------------------------------------------------------


class _JaxSpy:
    """Stands in for ``jax`` inside the reference's ``ffn`` module and
    records the (dest, token_of) arguments of its ``_dispatch_one`` vmap."""

    def __init__(self, record):
        self.record = record

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, f, *a, **kw):
        mapped = jax.vmap(f, *a, **kw)
        if getattr(f, "__name__", "") != "_dispatch_one":
            return mapped

        def call(*args):
            self.record.append([np.asarray(t) for t in args[1:]])
            return mapped(*args)
        return call


def _moe_input(case, b, s, d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, d).astype(np.float32)
    if case == "identical":       # every token alike: one run per expert
        x[:] = x[:, :1]
    elif case == "half":          # the first half alike, the rest random
        x[:, :s // 2] = x[:, :1]
    return x


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("case,cf,kind", [
    ("random", 1.25, "swiglu"), ("identical", 1.0, "swiglu"),
    ("half", 1.0, "swiglu"), ("random", 1.0, "geglu"),
    ("random", 8.0, "swiglu")])
def test_moe_apply_matches_the_reference(arch, case, cf, kind, monkeypatch):
    import repro.models.ffn as jffn
    cfg = get_smoke_config(arch)
    _, jparams, params = _weights(cfg)
    jmoe = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    moe = params["layers"][0]["moe"]
    b, s = 2, 16
    x = _moe_input(case, b, s, cfg.d_model, seed=len(case) + int(10 * cf))
    record = []
    monkeypatch.setattr(jffn, "jax", _JaxSpy(record))
    want, want_aux = jffn.moe_apply(jmoe, jnp.asarray(x), top_k=cfg.top_k,
                                    capacity_factor=cf, ffn_kind=kind)
    got, aux = moe_apply(moe, _t(x), top_k=cfg.top_k, capacity_factor=cf,
                         ffn_kind=kind)
    _close(got, want, what="output")
    _close(aux, want_aux, what="aux")
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    # routing: the reference's own dispatch indices
    (want_dest, want_tok), = record
    r = moe_route(moe["router"], _t(x), top_k=cfg.top_k, capacity_factor=cf)
    np.testing.assert_array_equal(r.dest.numpy(), want_dest)
    np.testing.assert_array_equal(r.token_of.numpy(), want_tok)
    sink = cfg.n_experts * r.cap
    dropped = Counter((i, int(t)) for i in range(b)
                      for t, dst in zip(want_tok[i], want_dest[i])
                      if dst == sink)
    got_dropped = Counter((i, int(t)) for i in range(b)
                          for t, dst in zip(r.token_of[i].tolist(),
                                            r.dest[i].tolist())
                          if dst == sink)
    assert got_dropped == dropped
    assert int(r.dropped()) == sum(dropped.values())
    if case == "identical":
        # every token picks the same experts: the first `cap` tokens of
        # each example pass, both choices of every later one drop
        assert r.cap == 4
        assert dropped == Counter({(i, t): cfg.top_k for i in range(b)
                                   for t in range(r.cap, s)})
    if cf == 8.0:
        assert not dropped


@pytest.mark.parametrize("s,k,cf,e", [(16, 2, 1.25, 8), (1, 8, 1.25, 384),
                                      (1, 8, 1.25, 256), (1024, 8, 1.25, 384),
                                      (1024, 8, 1.25, 256), (12, 2, 1.0, 8),
                                      (32, 8, 1.25, 256), (20, 2, 1.0, 8)])
def test_capacity_rounds_as_the_reference(s, k, cf, e):
    # the reference's ffn.py:102, Python's round (half to even) in both
    assert capacity(s, k, cf, e) == int(max(1, round(s * k * cf / e)))
    if s == 1:
        assert capacity(s, k, cf, e) == 1


# -- MLA ----------------------------------------------------------------------------


def _mla_pair(r_q, seed=0):
    from repro.models.mla import MLAConfig as JMLA
    from repro.models.mla import mla_init
    smoke = get_smoke_config("deepseek_v3_671b")
    kw = dict(d_model=smoke.d_model, n_heads=smoke.n_heads,
              qk_nope=smoke.qk_nope, qk_rope=smoke.qk_rope,
              v_dim=smoke.v_dim, r_kv=smoke.r_kv, r_q=r_q)
    jp = mla_init(jax.random.PRNGKey(seed), JMLA(**kw))
    return JMLA(**kw), jp, MLAConfig(**kw), \
        {k: _t(v) for k, v in jax.tree.map(np.asarray, jp).items()}


@pytest.mark.parametrize("r_q", [32, 0], ids=["latent_q", "full_q"])
@pytest.mark.parametrize("q_offset", [0, 5])
def test_mla_prefill_matches_the_reference(r_q, q_offset):
    from repro.models.mla import mla_prefill as jprefill
    jcfg, jp, cfg, p = _mla_pair(r_q)
    x = np.random.RandomState(r_q + q_offset).randn(2, 11, cfg.d_model
                                                    ).astype(np.float32)
    want, (wc, wk) = jprefill(jp, jcfg, jnp.asarray(x), q_offset=q_offset)
    got, (c_kv, k_rope) = mla_prefill(p, cfg, _t(x), q_offset=q_offset)
    _close(got, want, what="out")
    _close(c_kv, wc, what="c_kv")
    _close(k_rope, wk, what="k_rope")


@pytest.mark.parametrize("r_q", [32, 0], ids=["latent_q", "full_q"])
@pytest.mark.parametrize("length", [0, 6, 13])
def test_mla_decode_matches_the_reference(r_q, length):
    from repro.models.mla import MLACache as JCache
    from repro.models.mla import mla_decode as jdecode
    jcfg, jp, cfg, p = _mla_pair(r_q, seed=1)
    b, t = 3, 14
    rng = np.random.RandomState(length + r_q)
    x = rng.randn(b, 1, cfg.d_model).astype(np.float32)
    c_kv = rng.randn(b, t, cfg.r_kv).astype(np.float32)
    k_rope = rng.randn(b, t, cfg.qk_rope).astype(np.float32)
    want, wcache = jdecode(jp, jcfg, jnp.asarray(x), JCache(
        jnp.asarray(c_kv), jnp.asarray(k_rope), jnp.asarray(length,
                                                            jnp.int32)))
    got, cache = mla_decode(p, cfg, _t(x), MLACache(
        _t(c_kv), _t(k_rope), torch.tensor(length, dtype=torch.int32)))
    _close(got, want, what="out")
    _close(cache.c_kv, wcache.c_kv, what="c_kv")
    _close(cache.k_rope, wcache.k_rope, what="k_rope")
    assert int(cache.length) == int(wcache.length) == length + 1
    assert cache.length.dtype == torch.int32


# -- the models -----------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_prefill_and_loss_match_the_reference(arch):
    from repro.models import forward as jforward
    from repro.models import loss_fn as jloss
    from repro.models import prefill as jprefill
    cfg = get_smoke_config(arch)
    jcfg, jparams, params = _weights(cfg)
    toks, labels = _tokens(cfg, 2, 16, 1), _tokens(cfg, 2, 16, 2)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch = {"tokens": _t(toks), "labels": _t(labels)}
    want, want_aux = jforward(jcfg, jparams, jbatch)
    got, aux = forward_aux(cfg, params, batch)
    _close(got, want, what="logits")
    _close(aux, want_aux, what="aux")
    assert float(aux) > 0
    assert torch.equal(forward(cfg, params, batch), got)
    _close(prefill(cfg, params, batch), jprefill(jcfg, jparams, jbatch),
           what="prefill")
    _close(loss_fn(cfg, params, batch), jloss(jcfg, jparams, jbatch),
           what="loss")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_step_from_a_mid_stream_cache(arch):
    from repro.models import decode_step as jdecode
    from repro.models import init_cache as jinit_cache
    cfg = get_smoke_config(arch)
    jcfg, jparams, params = _weights(cfg)
    b, prompt, more, max_len = 2, 5, 4, 12
    toks = _tokens(cfg, b, prompt + more, 3)
    jstate = jinit_cache(jcfg, b, max_len=max_len)
    for t in range(prompt):
        _, jstate = jdecode(jcfg, jparams, jstate,
                            {"token": jnp.asarray(toks[:, t:t + 1])})
    state = cache_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                           device="cpu")
    kind = MLACache if cfg.attn_kind == "mla" else type(state.caches[0].kv)
    assert all(isinstance(c.kv, kind) and int(c.kv.length) == prompt
               for c in state.caches)
    for t in range(prompt, prompt + more):
        want, jstate = jdecode(jcfg, jparams, jstate,
                               {"token": jnp.asarray(toks[:, t:t + 1])})
        got, state = decode_step(cfg, params, state,
                                 {"token": _t(toks[:, t:t + 1])})
        _close(got, want, what=f"logits at {t}")
    for i, c in enumerate(state.caches):
        for field in type(c.kv)._fields:
            _close(getattr(c.kv, field),
                   np.asarray(getattr(jstate.caches.kv, field))[i],
                   what=f"layer {i} {field}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_over_a_prompt_matches_forward(arch):
    # tests/test_models.py's measure, at its no-drop capacity
    cfg = dataclasses.replace(get_smoke_config(arch), moe_capacity=8.0)
    params = init_params(cfg, seed=0, device="cpu")
    b, s = 2, 12
    toks = _t(_tokens(cfg, b, s, 4))
    full = forward(cfg, params, {"tokens": toks})
    state = init_cache(cfg, b, max_len=s + 4, device="cpu")
    outs = []
    for t in range(s):
        lg, state = decode_step(cfg, params, state, {"token": toks[:, t:t + 1]})
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    rel = float((dec - full).abs().max()) / max(float(full.abs().max()), 1e-6)
    assert rel < 2e-2, rel


# -- serve ------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_generation_runs(arch):
    # the twin of tests/test_system.py's TestServe.test_generation_runs
    r = serve(get_smoke_config(arch), batch=2, prompt_len=8, gen=4,
              device="cpu")
    assert r["tokens"].shape == (2, 4)
    assert r["decode_tok_per_s"] > 0
    assert {"prefill_s", "decode_s", "decode_tok_per_s", "tokens"} <= set(r)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_is_the_reference_decode_loop(arch):
    """Greedy tokens equal the reference's decode loop (its ``serve``'s,
    ``repro/launch/serve.py:352-378``) run on the port's weights, and a
    second run gives the same tokens."""
    from repro.models import decode_step as jdecode
    from repro.models import init_cache as jinit_cache
    cfg = get_smoke_config(arch)
    batch, prompt_len, gen, seed = 2, 8, 6, 3
    r1 = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed,
               device="cpu")
    r2 = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed,
               device="cpu")
    assert np.array_equal(r1["tokens"], r2["tokens"])
    params = init_params(cfg, seed=seed, device="cpu")
    layers = jax.tree.map(lambda *a: jnp.stack(a), *[
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), lp)
        for lp in params["layers"]])
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()
               if k != "layers"}
    jparams["layers"] = layers
    jcfg = _jax_cfg(cfg)
    step = jax.jit(lambda p, s, i: jdecode(jcfg, p, s, i))
    state = jinit_cache(jcfg, batch, max_len=prompt_len + gen + 1)
    prompt = jnp.asarray(r1["prompt"], jnp.int32)
    for t in range(prompt_len):
        logits, state = step(jparams, state, {"token": prompt[:, t:t + 1]})
    _close(r1["prompt_logits"], logits, what="prompt logits")
    out = []
    for _ in range(gen):
        nxt = jnp.argmax(logits[:, -1], axis=-1)
        out.append(np.asarray(nxt))
        logits, state = step(jparams, state, {"token": nxt[:, None]})
    np.testing.assert_array_equal(r1["tokens"], np.stack(out, axis=1))


# -- gradients ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_value_and_grad_matches_the_reference(arch):
    """The twin of tests/test_models.py's capacity-drop test (capacity
    1.0, b=2, s=32): a finite loss, and loss and every gradient against
    ``jax.value_and_grad``."""
    from repro.models import loss_fn as jloss
    cfg = dataclasses.replace(get_smoke_config(arch), moe_capacity=1.0)
    jcfg, jparams, params = _weights(cfg)
    toks, labels = _tokens(cfg, 2, 32, 5), _tokens(cfg, 2, 32, 6)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want, jgrads = jax.value_and_grad(
        lambda p: jloss(jcfg, p, jbatch))(jparams)
    leaves, tree = torch.utils._pytree.tree_flatten(params)
    leaves = [t.requires_grad_() for t in leaves]
    loss = loss_fn(cfg, torch.utils._pytree.tree_unflatten(leaves, tree),
                   {"tokens": _t(toks), "labels": _t(labels)})
    assert np.isfinite(float(loss.detach()))
    _close(loss, want, what="loss")
    grads = torch.autograd.grad(loss, leaves)
    want_g = torch.utils._pytree.tree_flatten(params_from_jax(
        jax.tree.map(np.asarray, jgrads), cfg, device="cpu"))[0]
    assert len(want_g) == len(grads)
    for g, w in zip(grads, want_g):
        assert g.shape == w.shape
        _close(g, w.numpy(), what="gradient")


# -- optimize ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_optimize_refuses_a_symbolic_sequence(arch):
    """The capacity ``round(s k cf / E)`` pins an expression of ``s``:
    capture raises, as the reference stops there (ffn.py:102)."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=0, device="cpu")
    B, S = symbolic_dims("b, s")
    specs = {k: v for k, v in batch_specs(cfg, B, S).items() if k != "labels"}
    with pytest.raises(ValueError, match="pinned .*'s'"):
        optimize(make_prefill_step(cfg), spec_like(params), specs,
                 dynamic_dims={"b": (1, 8), "s": (16, 256)}, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_optimize_with_b_alone_equals_the_eager_prefill(arch):
    """A concrete s fixes the capacity: one plan serves every b, bitwise
    equal to the eager prefill (the reference plans too, but its first
    call raises inside ``jnp.searchsorted`` under ``vmap``)."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=0, device="cpu")
    (B,) = symbolic_dims("b")
    specs = {k: v for k, v in batch_specs(cfg, B, 32).items()
             if k != "labels"}
    opt = optimize(make_prefill_step(cfg), spec_like(params), specs,
                   dynamic_dims={"b": (1, 8)}, device="cpu")
    for b in (1, 3, 8):
        batch = {"tokens": _t(_tokens(cfg, b, 32, b))}
        assert torch.equal(opt(params, batch), prefill(cfg, params, batch))
    assert opt.last_report.stats.device_peak <= opt.guaranteed_peak_bytes


def test_capture_refuses_an_int_of_a_size():
    """The rule the MoE refusal rests on, on a two-line step: a number
    computed from a dim's size and used as a size pins that dim."""
    from repro_torch.core import TensorSpec

    def step(x):
        n = int(max(1, round(x.shape[0] * 0.3)))
        return x[:n] * 2

    (S,) = symbolic_dims("s")
    with pytest.raises(ValueError, match="pinned"):
        optimize(step, TensorSpec((S, 4), torch.float32),
                 dynamic_dims={"s": (4, 64)}, device="cpu")


def test_chip_smoke_depths_fit_one_card():
    """chip_smoke.py's MoE depths: the deepest whose bf16 weights leave an
    80 GB card room for an (8, 1024) request (kimi_k2 1 layer, 38.85 GB;
    deepseek_v3 2 layers, 49.74 GB); one layer more would take 72 GB or
    more."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert [a for a, _ in smoke.MOE_MODELS] == MOE_ARCHS
    for arch, layers in smoke.MOE_MODELS:
        cfg = get_config(arch)
        weights = 2 * dataclasses.replace(cfg, n_layers=layers).param_count()
        deeper = 2 * dataclasses.replace(cfg,
                                         n_layers=layers + 1).param_count()
        assert weights < 52e9 and deeper > 72e9, (arch, weights, deeper)
