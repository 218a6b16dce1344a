"""The xLSTM family on the port against the reference, on the CPU.

``xlstm_1p3b``: groups of mLSTM layers (matrix memory, chunkwise in the
forward, recurrent in decode), each closed by an sLSTM layer (scalar
memory, a recurrence over time); no attention, no FFN.  Its smoke config
in f32, weights through ``params_from_jax``:

* the configs, ``param_count``, ``xlstm_config`` and ``xlstm_meta`` equal
  the reference's, and the full config's row of ``tests/test_models.py``;
* ``mlstm_chunkwise`` (chunk 8, a ragged S, with and without an initial
  state, the final (C, n, m) too), ``mlstm_apply``, ``slstm_apply`` and
  both decode steps against the reference's, and the twin of
  ``tests/test_models.py``'s chunkwise mLSTM vs its recurrence;
* one bf16 ``mlstm_apply`` with a nonzero ``out_norm``;
* the smoke forward, ``prefill`` and ``loss_fn`` at S 29 (one chunk) and
  S 200 (two chunks, the second padded);
* ``decode_step`` from a mid-stream cache (``cache_from_jax`` with its
  ``MLSTMCache`` and ``SLSTMCache``), decode against the forward, and
  ``serve``: the reference's generation test, and its tokens equal to
  the reference's decode loop run on the port's weights;
* ``optimize`` refuses a symbolic ``(b, s)`` at the mLSTM's chunk split,
  where the reference stops; with ``b`` alone the port's plan equals the
  eager prefill bitwise at every ``b``.

Inputs are made with numpy from a seed; f32 is held to 2e-4.
"""
import dataclasses
import functools

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
from repro_torch.models.lm import xlstm_meta
from repro_torch.models.xlstm import (MLSTMCache, SLSTMCache, XLSTMConfig,
                                      mlstm_apply, mlstm_chunkwise,
                                      mlstm_decode_step, mlstm_init_cache,
                                      slstm_apply, slstm_decode_step)

TOL = 2e-4
ARCH = "xlstm_1p3b"
# the mixers' own tests: d 16, 2 heads (hd 16), chunk 8, as the reference's
MIXER = dict(d_model=16, n_heads=2, proj_factor=2.0, chunk=8)


def _close(got, want, tol=TOL, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _t(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _smoke():
    return get_smoke_config(ARCH)


def _jcfg():
    from repro.configs import get_smoke_config as jget
    return jget(ARCH)


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's smoke weights (jax) and the port's copy, made once
    (no test writes into them)."""
    from repro.models import init_params as jinit
    jparams = jax.jit(lambda key: jinit(_jcfg(), key))(jax.random.PRNGKey(0))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    _smoke(), device="cpu")


@functools.lru_cache(maxsize=None)
def _jdecode_step():
    from repro.models import decode_step as jdecode
    jcfg = _jcfg()
    return jax.jit(lambda p, s, i: jdecode(jcfg, p, s, i))


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab,
                                               (b, s)).astype(np.int32)


def _to_jax(params):
    """The port's parameter dict in the reference's layout: the mLSTM
    layers stacked (n_groups, m_per_group, ...), the sLSTM's (n_s, ...)."""
    def leaves(d):
        return {k: jnp.asarray(v.numpy()) for k, v in d.items()}

    def stack(*trees):
        return jax.tree.map(lambda *a: jnp.stack(a), *trees)
    out = {k: jnp.asarray(v.numpy()) for k, v in params.items()
           if k not in ("mlstm", "slstm")}
    out["mlstm"] = stack(*[stack(*[leaves(lp) for lp in group])
                           for group in params["mlstm"]])
    out["slstm"] = stack(*[leaves(sp) for sp in params["slstm"]])
    return out


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_configs_equal_the_reference(which):
    import importlib

    from repro.models.lm import xlstm_meta as jmeta
    ref = getattr(importlib.import_module(f"repro.configs.{ARCH}"), which)
    port = getattr(importlib.import_module(f"repro_torch.configs.{ARCH}"),
                   which)
    shared = {f.name for f in dataclasses.fields(port)} & \
        {f.name for f in dataclasses.fields(ref)}
    assert {"block_kind", "slstm_every", "xlstm_proj_factor"} <= shared
    assert {n: getattr(port, n) for n in shared} == \
        {n: getattr(ref, n) for n in shared}
    assert port.param_count() == ref.param_count()
    assert port.xlstm_config()._asdict() == ref.xlstm_config()._asdict()
    assert xlstm_meta(port) == jmeta(ref)
    assert ARCH in ARCHS
    if which == "CONFIG":
        # the twin of tests/test_models.py's row for this arch
        cfg = get_config(ARCH)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.d_ff, cfg.vocab) == (48, 2048, 4, 4, 0, 50304)
        assert port.param_count() == 3_526_950_912
        assert xlstm_meta(port) == dict(n_groups=6, m_per_group=7, n_s=6)
        assert port.xlstm_config().head_dim == 1024


def test_an_unported_block_is_refused():
    cfg = _smoke()
    init_cache(cfg, 2, 8, device="cpu")          # xLSTM reaches init_cache
    for bad in (dataclasses.replace(cfg, block_kind="transformer"),
                dataclasses.replace(cfg, block_kind="mamba", family="dense")):
        with pytest.raises(NotImplementedError, match="not ported"):
            init_cache(bad, 2, 8, device="cpu")


# -- the mixers ---------------------------------------------------------------


def _mixer_pair(seed=0, dtype=jnp.float32):
    from repro.models.xlstm import XLSTMConfig as JX
    from repro.models.xlstm import mlstm_init, slstm_init
    jcfg = JX(**MIXER)
    key = jax.random.PRNGKey(seed)
    jm = mlstm_init(key, jcfg, dtype)
    js = slstm_init(jax.random.fold_in(key, 1), jcfg, dtype)
    m = {k: _t(v) for k, v in jax.tree.map(np.asarray, jm).items()}
    s = {k: _t(v) for k, v in jax.tree.map(np.asarray, js).items()}
    for name in ("w_igate", "b_igate", "w_fgate", "b_fgate"):
        assert m[name].dtype == torch.float32, name
    for name in ("w_i", "w_f", "b_f"):
        assert s[name].dtype == torch.float32, name
    return jcfg, jm, js, XLSTMConfig(**MIXER), m, s


@pytest.mark.parametrize("s", [29, 8, 5])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunkwise_matches_the_reference(s, with_state):
    from repro.models.xlstm import mlstm_chunkwise as jchunk
    rng = np.random.RandomState(s + 10 * with_state)
    b, h, hd = 2, 2, 8
    q, k, v = (rng.randn(b, h, s, hd).astype(np.float32) for _ in range(3))
    log_i = rng.randn(b, h, s).astype(np.float32)
    log_f = np.log(1 / (1 + np.exp(-rng.randn(b, h, s) - 2))).astype(
        np.float32)
    state = None
    if with_state:
        state = (rng.randn(b, h, hd, hd).astype(np.float32),
                 rng.randn(b, h, hd).astype(np.float32),
                 rng.randn(b, h).astype(np.float32))
    want_h, want_state = jax.jit(functools.partial(jchunk, chunk=8))(
        *(jnp.asarray(a) for a in (q, k, v, log_i, log_f)),
        state=None if state is None else tuple(jnp.asarray(a)
                                               for a in state))
    got_h, got_state = mlstm_chunkwise(
        *(_t(a) for a in (q, k, v, log_i, log_f)),
        state=None if state is None else tuple(_t(a) for a in state),
        chunk=8)
    _close(got_h, want_h, what="h")
    for got, want, name in zip(got_state, want_state, "Cnm"):
        assert got.dtype == torch.float32
        _close(got, want, what=f"final {name}")


@pytest.mark.parametrize("s", [29, 16])
def test_mlstm_and_slstm_apply_match_the_reference(s):
    from repro.models.xlstm import mlstm_apply as jm_apply
    from repro.models.xlstm import slstm_apply as js_apply
    jcfg, jm, js, cfg, m, sp = _mixer_pair(seed=s)
    x = np.random.RandomState(s).randn(2, s, 16).astype(np.float32) * 0.3
    want_m, want_s = jax.jit(lambda a, b_, x_: (
        jm_apply(a, jcfg, x_), js_apply(b_, jcfg, x_)))(jm, js,
                                                        jnp.asarray(x))
    _close(mlstm_apply(m, cfg, _t(x)), want_m, what="mlstm_apply")
    _close(slstm_apply(sp, cfg, _t(x)), want_s, what="slstm_apply")


def test_decode_steps_match_the_reference():
    from repro.models.xlstm import MLSTMCache as JM
    from repro.models.xlstm import SLSTMCache as JS
    from repro.models.xlstm import mlstm_decode_step as jm_step
    from repro.models.xlstm import slstm_decode_step as js_step
    jcfg, jm, js, cfg, m, sp = _mixer_pair(seed=3)
    rng = np.random.RandomState(3)
    b, h, hd, di = 3, cfg.n_heads, cfg.head_dim, cfg.d_inner
    x = rng.randn(b, 1, 16).astype(np.float32)
    mc = (rng.randn(b, cfg.conv_kernel - 1, di).astype(np.float32),
          rng.randn(b, h, hd, hd).astype(np.float32),
          rng.randn(b, h, hd).astype(np.float32),
          rng.randn(b, h).astype(np.float32))
    sc = (rng.randn(b, di).astype(np.float32),
          np.abs(rng.randn(b, di)).astype(np.float32),
          rng.randn(b, di).astype(np.float32))
    (want_m, wmc), (want_s, wsc) = jax.jit(lambda a, b_, x_, c1, c2: (
        jm_step(a, jcfg, x_, c1), js_step(b_, jcfg, x_, c2)))(
            jm, js, jnp.asarray(x), JM(*map(jnp.asarray, mc)),
            JS(*map(jnp.asarray, sc)))
    got_m, gmc = mlstm_decode_step(m, cfg, _t(x), MLSTMCache(*map(_t, mc)))
    got_s, gsc = slstm_decode_step(sp, cfg, _t(x), SLSTMCache(*map(_t, sc)))
    _close(got_m, want_m, what="mlstm y")
    for f in MLSTMCache._fields:
        _close(getattr(gmc, f), getattr(wmc, f), what=f"mlstm {f}")
    _close(got_s, want_s, what="slstm y")
    for f in SLSTMCache._fields:
        _close(getattr(gsc, f), getattr(wsc, f), what=f"slstm {f}")


def test_mlstm_chunkwise_matches_recurrent():
    """The twin of tests/test_models.py's TestMLSTM: the chunkwise mLSTM
    == its step-by-step recurrence (chunk 8, S 29: 4 chunks, the last
    padded)."""
    _, _, _, cfg, m, _ = _mixer_pair(seed=0)
    x = _t(np.random.RandomState(0).randn(2, 29, 16).astype(np.float32)
           * 0.3)
    y_full = mlstm_apply(m, cfg, x)
    cache = mlstm_init_cache(cfg, 2, torch.float32)
    ys = []
    for t in range(29):
        y, cache = mlstm_decode_step(m, cfg, x[:, t:t + 1], cache)
        ys.append(y[:, 0])
    err = float((y_full - torch.stack(ys, dim=1)).abs().max())
    assert err < 1e-3, err


def test_bf16_mlstm_apply_with_a_nonzero_out_norm():
    """bf16, ``out_norm`` away from its zero init: within 5e-2 of the
    reference.  The two compute the output norm apart by one rounding: the
    reference forms ``1.0 + out_norm`` in bf16 before promoting it to f32
    (``repro/models/xlstm.py:172``), the port's RMSNorm op (as
    ``rms_norm``) adds in f32; the two factors differ by at most one bf16
    ulp of (1 + out_norm) a column, and agree exactly at the zero init."""
    from repro.models.xlstm import mlstm_apply as jm_apply
    jcfg, jm, _, cfg, m, _ = _mixer_pair(seed=5, dtype=jnp.bfloat16)
    norm = np.random.RandomState(5).randn(cfg.d_inner).astype(np.float32)
    jm = dict(jm, out_norm=jnp.asarray(norm * 0.3, jnp.bfloat16))
    m = dict(m, out_norm=_t(np.asarray(jm["out_norm"])))
    assert m["out_norm"].dtype == torch.bfloat16 and \
        m["w_igate"].dtype == torch.float32
    x = np.random.RandomState(6).randn(2, 21, 16).astype(np.float32) * 0.3
    want = jax.jit(lambda p, x_: jm_apply(p, jcfg, x_))(
        jm, jnp.asarray(x, jnp.bfloat16))
    got = mlstm_apply(m, cfg, _t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), tol=5e-2, what="bf16")
    one = np.asarray((1.0 + jm["out_norm"]).astype(jnp.float32))
    assert 0 < np.abs(one - (1.0 + m["out_norm"].float().numpy())).max() \
        <= 2 ** -7


# -- the model ----------------------------------------------------------------


@pytest.mark.parametrize("s", [29, 200])
def test_forward_prefill_and_loss_match_the_reference(s):
    from repro.models import forward as jforward
    from repro.models import loss_fn as jloss
    from repro.models import prefill as jprefill
    cfg, jcfg = _smoke(), _jcfg()
    jparams, params = _weights()
    toks, labels = _tokens(cfg, 2, s, 1), _tokens(cfg, 2, s, 2)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch = {"tokens": _t(toks), "labels": _t(labels)}
    want, want_aux, want_prefill, want_loss = jax.jit(lambda p, b: (
        *jforward(jcfg, p, b), jprefill(jcfg, p, b),
        jloss(jcfg, p, b)))(jparams, jbatch)
    _close(forward(cfg, params, batch), want, what="logits")
    logits, aux = forward_aux(cfg, params, batch)
    assert float(aux) == float(want_aux) == 0.0
    _close(prefill(cfg, params, batch), want_prefill, what="prefill")
    _close(loss_fn(cfg, params, batch), want_loss, what="loss")


def test_init_params_draws_the_xlstm_leaves():
    cfg = _smoke()
    meta = xlstm_meta(cfg)
    _, ref = _weights()
    for dtype in ("float32", "bfloat16"):
        params = init_params(dataclasses.replace(cfg, dtype=dtype), seed=0,
                             device="cpu")
        assert "layers" not in params
        assert len(params["mlstm"]) == meta["n_groups"] and \
            len(params["mlstm"][0]) == meta["m_per_group"] and \
            len(params["slstm"]) == meta["n_s"]
        for got, want in ((params["mlstm"][0][0], ref["mlstm"][0][0]),
                          (params["slstm"][0], ref["slstm"][0])):
            assert sorted(got) == sorted(want)
            for name, t in got.items():
                assert t.shape == want[name].shape, name
                f32 = name in ("w_igate", "b_igate", "w_fgate", "b_fgate",
                               "w_i", "w_f", "b_f")
                assert t.dtype == (torch.float32 if f32 or dtype == "float32"
                                   else torch.bfloat16), name


def test_decode_step_from_a_mid_stream_cache():
    from repro.models import init_cache as jinit_cache
    cfg, jcfg = _smoke(), _jcfg()
    jparams, params = _weights()
    b, prompt, more = 2, 18, 6
    toks = _tokens(cfg, b, prompt + more, 3)
    step = _jdecode_step()
    jstate = jinit_cache(jcfg, b, max_len=prompt + more + 1)
    for t in range(prompt):
        _, jstate = step(jparams, jstate,
                         {"token": jnp.asarray(toks[:, t:t + 1])})
    state = cache_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                           device="cpu")
    m_caches, s_caches = state.xlstm
    assert state.caches is None
    assert all(isinstance(c, MLSTMCache) for g in m_caches for c in g)
    assert all(isinstance(c, SLSTMCache) for c in s_caches)
    for t in range(prompt, prompt + more):
        want, jstate = step(jparams, jstate,
                            {"token": jnp.asarray(toks[:, t:t + 1])})
        got, state = decode_step(cfg, params, state,
                                 {"token": _t(toks[:, t:t + 1])})
        _close(got, want, what=f"logits at {t}")
    jm, js = jstate.xlstm
    for g, group in enumerate(state.xlstm[0]):
        for j, c in enumerate(group):
            for f in MLSTMCache._fields:
                _close(getattr(c, f), np.asarray(getattr(jm, f))[g, j],
                       what=f"mlstm {g} {j} {f}")
    for g, c in enumerate(state.xlstm[1]):
        for f in SLSTMCache._fields:
            _close(getattr(c, f), np.asarray(getattr(js, f))[g],
                   what=f"slstm {g} {f}")


def test_decode_matches_forward():
    """The chunkwise forward and the recurrent decode agree at every
    position (S 40)."""
    cfg = _smoke()
    params = init_params(cfg, seed=0, device="cpu")
    toks = _t(_tokens(cfg, 2, 40, 4))
    full = forward(cfg, params, {"tokens": toks})
    state = init_cache(cfg, 2, max_len=41, device="cpu")
    outs = []
    for t in range(40):
        lg, state = decode_step(cfg, params, state,
                                {"token": toks[:, t:t + 1]})
        outs.append(lg[:, 0])
    _close(torch.stack(outs, dim=1), full.numpy(), what="decode vs forward")


# -- serve --------------------------------------------------------------------


def test_generation_runs():
    # the twin of tests/test_system.py's TestServe.test_generation_runs
    r = serve(_smoke(), batch=2, prompt_len=8, gen=4, device="cpu")
    assert r["tokens"].shape == (2, 4)
    assert r["decode_tok_per_s"] > 0
    assert {"prefill_s", "decode_s", "decode_tok_per_s", "tokens"} <= set(r)
    m_caches, s_caches = r["state"].xlstm
    assert r["state"].caches is None
    assert all(c.c.dtype == torch.float32 and c.c.shape == (2, 2, 64, 64)
               for g in m_caches for c in g)
    assert len(s_caches) == xlstm_meta(_smoke())["n_s"]


def test_serve_is_the_reference_decode_loop():
    """Greedy tokens equal the reference's decode loop (its ``serve``'s)
    run on the port's weights, and a second run gives the same tokens."""
    from repro.models import init_cache as jinit_cache
    cfg = _smoke()
    batch, prompt_len, gen, seed = 2, 12, 8, 3
    r1 = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed,
               device="cpu")
    r2 = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed,
               device="cpu")
    assert np.array_equal(r1["tokens"], r2["tokens"])
    jparams = _to_jax(init_params(cfg, seed=seed, device="cpu"))
    step = _jdecode_step()
    state = jinit_cache(_jcfg(), batch, max_len=prompt_len + gen + 1)
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
    """The mLSTM's chunk split ``min(chunk, s)`` needs a concrete s:
    capture raises there, as the reference stops at
    ``repro/models/xlstm.py:81`` (``InconclusiveDimensionOperation: 's' <
    '128'``)."""
    cfg = _smoke()
    params = init_params(cfg, seed=0, device="cpu")
    B, S = symbolic_dims("b, s")
    specs = {k: v for k, v in batch_specs(cfg, B, S).items() if k != "labels"}
    with pytest.raises(ValueError, match="mlstm_chunkwise"):
        optimize(make_prefill_step(cfg), spec_like(params), specs,
                 dynamic_dims={"b": (1, 8), "s": (16, 256)}, device="cpu")


def test_optimize_with_b_alone_equals_the_eager_prefill():
    """A concrete s fixes the chunks and the sLSTM's steps: one plan serves
    every b, bitwise equal to the eager prefill (the reference plans too,
    but its first call raises a ``TypeError`` on the group's layer-scan
    carry, float32[1, ...] against float32[b, ...])."""
    cfg = _smoke()
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
