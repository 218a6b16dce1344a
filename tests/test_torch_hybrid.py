"""The hybrid family on the port against the reference, on the CPU.

``hymba_1p5b``: attention and a selective SSM side by side in every layer,
sliding-window attention except at the global layers {first, middle,
last}.  Its smoke config in f32, weights through ``params_from_jax``:

* the configs, ``param_count``, ``ssm_config`` and ``layer_windows``
  equal the reference's;
* ``selective_scan_chunked`` (chunk 8, a ragged S, with and without an
  initial state), ``ssm_apply`` and ``ssm_decode_step`` against the
  reference's, and the twin of ``tests/test_models.py``'s chunked scan vs
  the step-by-step recurrence;
* ``blockwise_attention``, forward and gradients, with and without a
  window and a pad mask, against the reference's ``jax.grad``;
* ``attention`` with a window: the flash op where the window covers the
  sequence, the reference's dense (and past 2048 its blockwise) attention
  where it does not, equal to the reference and apart from the
  unwindowed result;
* the smoke forward, ``prefill`` and ``loss_fn`` at 2 layers (both
  global) and 4 (layer 1 windowed), on prompts past the window of 16;
* ``decode_step`` from a mid-stream cache (``cache_from_jax`` with its
  ``SSMCache``), decode past the window against the forward, and
  ``serve``: the reference's generation test, and its tokens equal to
  the reference's decode loop run on the port's weights;
* ``optimize`` refuses a symbolic ``(b, s)`` at the SSM's chunk split,
  where the reference stops; with ``b`` alone the port's plan equals the
  eager prefill at every ``b``.

Inputs are made with numpy from a seed; f32 is held to 2e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.core import optimize, spec_like, symbolic_dims
from repro_torch.launch.serve import serve
from repro_torch.launch.specs import batch_specs
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import (cache_from_jax, decode_step, forward,
                                init_cache, init_params, loss_fn,
                                params_from_jax, prefill)
from repro_torch.models import attention as attn_mod
from repro_torch.models.lm import layer_windows
from repro_torch.models.ssm import (SSMCache, SSMConfig,
                                    selective_scan_chunked, ssm_apply,
                                    ssm_decode_step, ssm_init_cache)

TOL = 2e-4
ARCH = "hymba_1p5b"


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _smoke(n_layers=2):
    return dataclasses.replace(get_smoke_config(ARCH), n_layers=n_layers)


def _jcfg(cfg):
    from repro.configs import get_smoke_config as jget
    return dataclasses.replace(jget(ARCH), n_layers=cfg.n_layers)


def _weights(cfg):
    """Reference weights (jax) at cfg's depth and the port's copy, made
    once a depth (no test writes into them)."""
    return _weights_at(cfg.n_layers)


@functools.lru_cache(maxsize=None)
def _weights_at(n_layers):
    from repro.models import init_params as jinit
    cfg = _smoke(n_layers)
    jcfg = _jcfg(cfg)
    jparams = jax.jit(lambda key: jinit(jcfg, key))(jax.random.PRNGKey(0))
    return jcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _jdecode_step(n_layers):
    """The reference's decode step at that depth, jitted once."""
    from repro.models import decode_step as jdecode
    jcfg = _jcfg(_smoke(n_layers))
    return jax.jit(lambda p, s, i: jdecode(jcfg, p, s, i))


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab,
                                               (b, s)).astype(np.int32)


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_configs_equal_the_reference(which):
    import importlib
    ref = getattr(importlib.import_module(f"repro.configs.{ARCH}"), which)
    port = getattr(importlib.import_module(f"repro_torch.configs.{ARCH}"),
                   which)
    shared = {f.name for f in dataclasses.fields(port)} & \
        {f.name for f in dataclasses.fields(ref)}
    assert {"window", "ssm_state", "ssm_expand"} <= shared
    assert {n: getattr(port, n) for n in shared} == \
        {n: getattr(ref, n) for n in shared}
    assert port.param_count() == ref.param_count()
    assert port.ssm_config()._asdict() == ref.ssm_config()._asdict()
    assert ARCH in ARCHS
    if which == "CONFIG":
        assert port.resolved_head_dim == 64 and port.padded_vocab == 32128
        assert 1.4e9 < port.param_count() < 1.8e9


@pytest.mark.parametrize("n_layers", [1, 2, 4, 32])
def test_layer_windows_equal_the_reference(n_layers):
    from repro.configs import get_config as jget
    from repro.models.lm import layer_windows as jwindows
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=n_layers)
    jcfg = dataclasses.replace(jget(ARCH), window=cfg.window,
                               n_layers=n_layers)
    assert layer_windows(cfg) == jwindows(jcfg).tolist()
    assert layer_windows(dataclasses.replace(cfg, window=None)) is None


# -- the SSM ------------------------------------------------------------------


def _ssm_pair(seed=0, d_model=24, d_inner=48, d_state=4, chunk=8):
    from repro.models.ssm import SSMConfig as JSSM
    from repro.models.ssm import ssm_init
    kw = dict(d_model=d_model, d_inner=d_inner, d_state=d_state, chunk=chunk)
    jp = ssm_init(jax.random.PRNGKey(seed), JSSM(**kw))
    p = {k: _t(v) for k, v in jax.tree.map(np.asarray, jp).items()}
    assert p["a_log"].dtype == torch.float32
    return JSSM(**kw), jp, SSMConfig(**kw), p


@pytest.mark.parametrize("s", [37, 8, 5])
@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_chunked_matches_the_reference(s, with_h0):
    from repro.models.ssm import selective_scan_chunked as jscan
    rng = np.random.RandomState(s + 10 * with_h0)
    b, di, n = 2, 12, 4
    u, dt = (rng.randn(b, s, di).astype(np.float32) * 0.5 for _ in range(2))
    dt = np.log1p(np.exp(dt))                      # positive, as softplus
    bm, cm = (rng.randn(b, s, n).astype(np.float32) for _ in range(2))
    a_log = np.log(rng.uniform(0.5, 4.0, (di, n))).astype(np.float32)
    d_skip = rng.randn(di).astype(np.float32)
    h0 = rng.randn(b, di, n).astype(np.float32) if with_h0 else None
    want_y, want_h = jax.jit(functools.partial(jscan, chunk=8))(
        *(jnp.asarray(a) for a in (u, dt, a_log, bm, cm, d_skip)),
        h0=None if h0 is None else jnp.asarray(h0))
    got_y, got_h = selective_scan_chunked(
        *(_t(a) for a in (u, dt, a_log, bm, cm, d_skip)),
        h0=None if h0 is None else _t(h0), chunk=8)
    _close(got_y, want_y, what="y")
    _close(got_h, want_h, what="h_final")
    assert got_h.dtype == torch.float32


@pytest.mark.parametrize("s", [37, 16])
def test_ssm_apply_matches_the_reference(s):
    from repro.models.ssm import ssm_apply as japply
    jcfg, jp, cfg, p = _ssm_pair(seed=s)
    x = np.random.RandomState(s).randn(2, s, cfg.d_model).astype(
        np.float32) * 0.3
    want, want5 = jax.jit(lambda p_, x_: (
        japply(p_, jcfg, x_), japply(p_, jcfg, x_, chunk=5)))(
            jp, jnp.asarray(x))
    _close(ssm_apply(p, cfg, _t(x)), want, what="ssm_apply")
    _close(ssm_apply(p, cfg, _t(x), chunk=5), want5, what="chunk 5")


def test_ssm_decode_step_matches_the_reference():
    from repro.models.ssm import SSMCache as JCache
    from repro.models.ssm import ssm_decode_step as jstep
    jcfg, jp, cfg, p = _ssm_pair(seed=3)
    rng = np.random.RandomState(3)
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    conv = rng.randn(3, cfg.conv_kernel - 1, cfg.d_inner).astype(np.float32)
    h = rng.randn(3, cfg.d_inner, cfg.d_state).astype(np.float32)
    want, wcache = jax.jit(lambda p_, x_, c_: jstep(p_, jcfg, x_, c_))(
        jp, jnp.asarray(x), JCache(jnp.asarray(conv), jnp.asarray(h)))
    got, cache = ssm_decode_step(p, cfg, _t(x), SSMCache(_t(conv), _t(h)))
    _close(got, want, what="y")
    _close(cache.conv, wcache.conv, what="conv")
    _close(cache.h, wcache.h, what="h")


def test_chunked_scan_matches_stepwise():
    """The twin of tests/test_models.py's TestSSM: chunkwise selective
    scan == step-by-step recurrence."""
    _, _, cfg, p = _ssm_pair(seed=0)
    x = _t(np.random.RandomState(0).randn(2, 37, 24).astype(np.float32)
           * 0.3)
    y_full = ssm_apply(p, cfg, x)
    cache = ssm_init_cache(cfg, 2, torch.float32)
    ys = []
    for t in range(37):
        y, cache = ssm_decode_step(p, cfg, x[:, t:t + 1], cache)
        ys.append(y[:, 0])
    err = float((y_full - torch.stack(ys, dim=1)).abs().max())
    assert err < 1e-4, err


# -- attention ----------------------------------------------------------------


def _qkv(b, s, hq, hkv, hd, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, hd).astype(np.float32)
            for h in (hq, hkv, hkv))


def _pad_mask(b, t, seed):
    m = np.random.RandomState(seed).rand(b, t) > 0.3
    m[:, 0] = True          # every query sees a key
    return m


@pytest.mark.parametrize("window", [None, 8], ids=["global", "window8"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "pad"])
@pytest.mark.parametrize("t", [50, 48])
def test_blockwise_attention_and_gradients_match_the_reference(window,
                                                               masked, t):
    from repro.models.attention import blockwise_attention as jblock
    q, k, v = _qkv(2, t, 4, 2, 8, seed=t + (window or 0))
    mask = _pad_mask(2, t, t) if masked else None
    dout = np.random.RandomState(1).randn(2, t, 4, 8).astype(np.float32)

    def jloss(q_, k_, v_):
        o = jblock(q_, k_, v_, causal=True, window=window, block_kv=16,
                   pad_mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(o * jnp.asarray(dout)), o

    (_, want), wgrads = jax.jit(jax.value_and_grad(
        jloss, (0, 1, 2), has_aux=True))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    got = attn_mod.blockwise_attention(
        qt, kt, vt, causal=True, window=window, block_kv=16,
        pad_mask=None if mask is None else _t(mask))
    _close(got, want, what="out")
    grads = torch.autograd.grad((got * _t(dout)).sum(), (qt, kt, vt))
    for g, w, name in zip(grads, wgrads, "qkv"):
        _close(g, w, what=f"d{name}")
    if window is None and not masked:
        dense = attn_mod.dense_attention(_t(q), _t(k), _t(v))
        _close(got, dense.numpy(), what="blockwise vs dense")


@pytest.mark.parametrize("t,route", [(40, "dense"), (2100, "blockwise")])
def test_windowed_attention_takes_the_reference_route(t, route, monkeypatch):
    """A window the sequence reaches: dense attention with the window up
    to T = 2048, blockwise past it, as the reference's ``attention``; the
    result equals the reference's and differs from the unwindowed one."""
    from repro.models.attention import attention as jattention
    from repro.models.attention import dense_attention as jdense
    q, k, v = _qkv(1, t, 2, 1, 8, seed=t)
    calls = []
    for name in ("blockwise_attention", "dense_attention"):
        fn = getattr(attn_mod, name)
        monkeypatch.setattr(attn_mod, name, lambda *a, _f=fn, _n=name, **kw:
                            calls.append(_n) or _f(*a, **kw))
    window = 16
    got = attn_mod.attention(_t(q), _t(k), _t(v), window=window)
    assert calls == [f"{route}_attention"]
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jax.jit(functools.partial(jattention, window=window))(jq, jk, jv)
    _close(got, want, what="windowed attention")
    if route == "dense":
        _close(got, jax.jit(functools.partial(jdense, window=window))(
            jq, jk, jv), what="vs dense_attention")
    free = attn_mod.attention(_t(q), _t(k), _t(v))
    assert float((got - free).abs().max()) > 1e-2


@pytest.mark.parametrize("t,window", [(16, 16), (12, 2 ** 30)])
def test_a_window_the_sequence_stays_within_takes_the_flash_op(t, window,
                                                               monkeypatch):
    """T <= window: the mask ``kv_pos > q_pos - window`` holds at every
    causal pair, so the flash op computes the windowed function."""
    from repro.models.attention import dense_attention as jdense
    q, k, v = _qkv(2, t, 4, 2, 8, seed=t)
    for name in ("blockwise_attention", "dense_attention"):
        monkeypatch.setattr(attn_mod, name, None)
    got = attn_mod.attention(_t(q), _t(k), _t(v), window=window)
    assert torch.equal(got, attn_mod.attention(_t(q), _t(k), _t(v)))
    _close(got, jdense(*(jnp.asarray(a) for a in (q, k, v)),
                       window=window), what="flash vs windowed dense")


# -- the model ----------------------------------------------------------------


@pytest.mark.parametrize("n_layers", [2, 4])
def test_forward_prefill_and_loss_match_the_reference(n_layers):
    from repro.models import forward as jforward
    from repro.models import loss_fn as jloss
    from repro.models import prefill as jprefill
    cfg = _smoke(n_layers)
    assert (layer_windows(cfg)[1] == cfg.window) == (n_layers == 4)
    jcfg, jparams, params = _weights(cfg)
    toks, labels = _tokens(cfg, 2, 40, 1), _tokens(cfg, 2, 40, 2)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch = {"tokens": _t(toks), "labels": _t(labels)}
    want, want_prefill, want_loss = jax.jit(lambda p, b: (
        jforward(jcfg, p, b)[0], jprefill(jcfg, p, b),
        jloss(jcfg, p, b)))(jparams, jbatch)
    _close(forward(cfg, params, batch), want, what="logits")
    _close(prefill(cfg, params, batch), want_prefill, what="prefill")
    _close(loss_fn(cfg, params, batch), want_loss, what="loss")


def test_init_params_draws_the_hybrid_leaves():
    cfg = _smoke(2)
    params = init_params(cfg, seed=0, device="cpu")
    _, jparams, ref = _weights(cfg)
    lp, rp = params["layers"][0], ref["layers"][0]
    assert lp.keys() == rp.keys() and lp["ssm"].keys() == rp["ssm"].keys()
    for name, t in lp["ssm"].items():
        assert t.shape == rp["ssm"][name].shape
        assert t.dtype == rp["ssm"][name].dtype, name
    assert torch.equal(lp["ssm"]["a_log"], rp["ssm"]["a_log"])
    bf = init_params(dataclasses.replace(cfg, dtype="bfloat16"), seed=0,
                     device="cpu")
    assert bf["layers"][0]["ssm"]["a_log"].dtype == torch.float32
    assert bf["layers"][0]["ssm"]["in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("n_layers", [2, 4])
def test_decode_step_from_a_mid_stream_cache(n_layers):
    from repro.models import init_cache as jinit_cache
    cfg = _smoke(n_layers)
    jcfg, jparams, params = _weights(cfg)
    b, prompt, more, max_len = 2, 18, 6, 26
    toks = _tokens(cfg, b, prompt + more, 3)
    step = _jdecode_step(n_layers)
    jstate = jinit_cache(jcfg, b, max_len=max_len)
    for t in range(prompt):
        _, jstate = step(jparams, jstate,
                         {"token": jnp.asarray(toks[:, t:t + 1])})
    state = cache_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                           device="cpu")
    assert all(isinstance(c.ssm, SSMCache) and int(c.kv.length) == prompt
               for c in state.caches)
    for t in range(prompt, prompt + more):
        want, jstate = step(jparams, jstate,
                            {"token": jnp.asarray(toks[:, t:t + 1])})
        got, state = decode_step(cfg, params, state,
                                 {"token": _t(toks[:, t:t + 1])})
        _close(got, want, what=f"logits at {t}")
    for i, c in enumerate(state.caches):
        _close(c.kv.k, np.asarray(jstate.caches.kv.k)[i], what=f"{i} k")
        _close(c.ssm.conv, np.asarray(jstate.caches.ssm.conv)[i],
               what=f"{i} conv")
        _close(c.ssm.h, np.asarray(jstate.caches.ssm.h)[i], what=f"{i} h")


def test_decode_past_the_window_matches_forward():
    """4 layers (layer 1 windowed at 16): 40 tokens decoded one at a time
    equal the forward at every position, 24 of them past the window."""
    cfg = _smoke(4)
    params = init_params(cfg, seed=0, device="cpu")
    b, s = 2, 40
    toks = _t(_tokens(cfg, b, s, 4))
    full = forward(cfg, params, {"tokens": toks})
    state = init_cache(cfg, b, max_len=s + 1, device="cpu")
    outs = []
    for t in range(s):
        lg, state = decode_step(cfg, params, state,
                                {"token": toks[:, t:t + 1]})
        outs.append(lg[:, 0])
    _close(torch.stack(outs, dim=1), full.numpy(), what="decode vs forward")


# -- serve --------------------------------------------------------------------


def test_generation_runs():
    # the twin of tests/test_system.py's TestServe.test_generation_runs
    r = serve(get_smoke_config(ARCH), batch=2, prompt_len=8, gen=4,
              device="cpu")
    assert r["tokens"].shape == (2, 4)
    assert r["decode_tok_per_s"] > 0
    assert {"prefill_s", "decode_s", "decode_tok_per_s", "tokens"} <= set(r)
    assert all(int(c.kv.length) == 12 and c.ssm.h.dtype == torch.float32
               for c in r["state"].caches)


@pytest.mark.parametrize("n_layers", [2, 4])
def test_serve_is_the_reference_decode_loop(n_layers):
    """Greedy tokens equal the reference's decode loop (its ``serve``'s)
    run on the port's weights, past the window at 4 layers, and a second
    run gives the same tokens."""
    from repro.models import init_cache as jinit_cache
    cfg = _smoke(n_layers)
    batch, prompt_len, gen, seed = 2, 12, 8, 3
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
    step = _jdecode_step(n_layers)
    state = jinit_cache(_jcfg(cfg), batch, max_len=prompt_len + gen + 1)
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


# -- optimize -----------------------------------------------------------------


def test_optimize_refuses_a_symbolic_sequence():
    """The SSM's chunk split ``min(chunk, s)`` needs a concrete s: capture
    raises there, as the reference stops at ``repro/models/ssm.py:100``
    (``InconclusiveDimensionOperation: 's' < '256'``)."""
    cfg = _smoke(2)
    params = init_params(cfg, seed=0, device="cpu")
    B, S = symbolic_dims("b, s")
    specs = {k: v for k, v in batch_specs(cfg, B, S).items() if k != "labels"}
    with pytest.raises(ValueError, match="selective_scan_chunked"):
        optimize(make_prefill_step(cfg), spec_like(params), specs,
                 dynamic_dims={"b": (1, 8), "s": (16, 256)}, device="cpu")


def test_optimize_with_b_alone_equals_the_eager_prefill():
    """A concrete s fixes the chunks: one plan serves every b, bitwise
    equal to the eager prefill (the reference plans too, but its first
    call raises a ``TypeError`` on the chunk scan's carry, float32[1, ...]
    against float32[b, ...])."""
    cfg = _smoke(2)
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
