"""The rest of the dense family on the port against the reference, on the
CPU: granite_8b, starcoder2_7b, musicgen_medium (frame embeddings in, a
4-codebook head out) and internvl2_2b (a vision prefix, a padded vocab).

* the four configs (``CONFIG`` and ``SMOKE``) equal the reference's,
  fields and ``param_count``;
* ``forward``, ``prefill`` and ``loss_fn`` equal the reference's at the
  smoke widths (hd 16, and hd 12 for starcoder2);
* the pad-vocab mask on an internvl2 whose vocab needs padding;
* each prefill through one ``optimize`` plan over a symbolic range equals
  the reference's at three shapes, with one capture and ``device_peak``
  within ``guaranteed_peak_bytes``; internvl2's flash node attends over
  the expression ``s + vis_tokens``;
* ``decode_step`` equals the reference's from a mid-stream cache for
  musicgen (frames) and internvl2 (tokens), and decode over a prompt of
  frames equals the forward;
* ``serve`` in embeddings mode equals a decode loop written out by hand;
* ``batch_specs``/``decode_input_specs`` give the reference's shapes;
* the flash route rule, and the op refusing a variant name it contradicts;
* the plain attention at hd 12 and 16 equals the Pallas kernel in
  interpret mode.

Inputs are made with numpy from a seed; weights come from the reference's
``init_params`` through ``params_from_jax``; f32 is held to 2e-4.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.core import optimize, spec_like, symbolic_dims
from repro_torch.kernels import reference_attention
from repro_torch.launch.serve import serve
from repro_torch.launch.specs import batch_specs, decode_input_specs
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import (cache_from_jax, decode_step, forward,
                                init_cache, init_params, loss_fn,
                                params_from_jax, prefill)

TOL = 2e-4
DENSE = ["granite_8b", "starcoder2_7b", "musicgen_medium", "internvl2_2b"]
# the full configs' parameter counts (the reference's param_count)
FULL_PARAMS = {"granite_8b": 8_254_390_272, "starcoder2_7b": 10_116_661_248,
               "internvl2_2b": 1_699_497_984}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ARCH_OF = {get_smoke_config(a).name: a for a in DENSE}


def _weights(cfg, seed=0):
    """The reference's smoke config of the same name (at cfg's vocab), its
    weights and the port's copy of them."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import init_params as jinit
    jcfg = dataclasses.replace(jsmoke(_ARCH_OF[cfg.name]), vocab=cfg.vocab)
    jparams = jinit(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, params_from_jax(np_params, cfg, device="cpu")


def _batch(cfg, b, s, seed, labels=True):
    """numpy inputs of ``cfg``'s mode: ``s`` is the text's (or frames')
    length."""
    rng = np.random.RandomState(seed)
    out = {}
    if cfg.input_mode == "embeddings":
        out["frame_embed"] = rng.randn(b, s, cfg.d_model).astype(np.float32)
        if labels:
            out["labels"] = rng.randint(0, cfg.vocab, (b, s, cfg.n_codebooks)
                                        ).astype(np.int32)
        return out
    if cfg.input_mode == "vlm":
        out["vis_embed"] = rng.randn(b, cfg.vis_tokens, cfg.d_model
                                     ).astype(np.float32)
    out["tokens"] = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    if labels:
        out["labels"] = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("module", DENSE)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_configs_equal_the_reference(module, which):
    ref = getattr(importlib.import_module(f"repro.configs.{module}"), which)
    port = getattr(importlib.import_module(f"repro_torch.configs.{module}"),
                   which)
    shared = {f.name for f in dataclasses.fields(port)} & \
        {f.name for f in dataclasses.fields(ref)}
    assert {"n_codebooks", "vis_tokens", "input_mode"} <= shared
    assert {n: getattr(port, n) for n in shared} == \
        {n: getattr(ref, n) for n in shared}
    assert port.param_count() == ref.param_count()
    assert port.padded_vocab == ref.padded_vocab
    assert module in ARCHS
    if which == "CONFIG" and module in FULL_PARAMS:
        assert port.param_count() == FULL_PARAMS[module]
    if (module, which) == ("internvl2_2b", "CONFIG"):
        assert (port.vocab, port.padded_vocab) == (92_553, 92_672)


# -- forward, prefill, loss -----------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_and_loss_match_the_reference(arch):
    from repro.models import forward as jforward
    from repro.models import loss_fn as jloss
    from repro.models import prefill as jprefill
    cfg = get_smoke_config(arch)
    jcfg, jparams, params = _weights(cfg)
    batch = _batch(cfg, 2, 11, 3)
    jfull, _ = jforward(jcfg, jparams, _jax(batch))
    full = forward(cfg, params, _torch(batch))
    seq = 11 + (cfg.vis_tokens if cfg.input_mode == "vlm" else 0)
    want_shape = (2, seq) + ((cfg.n_codebooks,) if cfg.n_codebooks else ()) \
        + (cfg.padded_vocab,)
    assert tuple(full.shape) == want_shape
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=TOL,
                               atol=TOL)
    nolab = {k: v for k, v in batch.items() if k != "labels"}
    want = np.asarray(jprefill(jcfg, jparams, _jax(nolab)))
    got = prefill(cfg, params, _torch(nolab))
    assert tuple(got.shape) == (want_shape[0],) + want_shape[2:]
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(loss_fn(cfg, params, _torch(batch))),
                               float(jloss(jcfg, jparams, _jax(batch))),
                               rtol=TOL, atol=TOL)
    # the parameters the input mode implies
    assert ("embed" in params) == (cfg.input_mode != "embeddings")
    if cfg.n_codebooks:
        assert tuple(params["lm_head"].shape) == \
            (cfg.d_model, cfg.n_codebooks * cfg.padded_vocab)
    mine = init_params(cfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items() if k != "layers"} == \
        {k: tuple(v.shape) for k, v in params.items() if k != "layers"}


def test_the_pad_columns_never_win():
    from repro.models import forward as jforward
    cfg = dataclasses.replace(get_smoke_config("internvl2_2b"), vocab=100)
    assert cfg.padded_vocab == 128
    jcfg, jparams, params = _weights(cfg)
    batch = _batch(cfg, 2, 6, 8, labels=False)
    jfull, _ = jforward(jcfg, jparams, _jax(batch))
    full = forward(cfg, params, _torch(batch))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=TOL,
                               atol=TOL)
    assert bool((full[..., cfg.vocab:] == -1e30).all())
    assert bool((full[..., :cfg.vocab] > -1e29).all())
    assert int(full.argmax(-1).max()) < cfg.vocab
    last = prefill(cfg, params, _torch(batch))
    assert int(last.argmax(-1).max()) < cfg.vocab


# -- one optimize plan over a symbolic range --------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_through_one_plan_matches_the_reference(arch, monkeypatch):
    import repro_torch.core.api as api
    from repro.models import prefill as jprefill
    cfg = get_smoke_config(arch)
    jcfg, jparams, params = _weights(cfg)
    captures = []
    real = api.capture
    monkeypatch.setattr(api, "capture",
                        lambda *a, **kw: captures.append(1) or real(*a, **kw))
    B, S = symbolic_dims("b, s")
    specs = {k: v for k, v in batch_specs(cfg, B, S).items()
             if k != "labels"}
    opt = optimize(make_prefill_step(cfg), spec_like(params), specs,
                   dynamic_dims={"b": (1, 4), "s": (1, 48)}, device="cpu")
    for i, (b, s) in enumerate([(1, 1), (3, 17), (4, 48)]):
        batch = _batch(cfg, b, s, 20 + i, labels=False)
        want = np.asarray(jprefill(jcfg, jparams, _jax(batch)))
        got = opt(params, _torch(batch))
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        st = opt.last_report.stats
        assert st.device_peak <= opt.guaranteed_peak_bytes
        assert st.arena_bytes <= opt.arena_bound_bytes
    assert len(captures) == 1
    nodes = opt.plan.graph.nodes
    flash = [n for n in nodes
             if n.prim_name == "repro_torch.flash_attention.default"]
    assert len(flash) == cfg.n_layers
    assert sum(n.prim_name == "repro_torch.rmsnorm.default"
               for n in nodes) == 2 * cfg.n_layers + 1
    seq = str(flash[0].invals[0].dims[2])
    want_seq = f"{cfg.vis_tokens} + s" if cfg.input_mode == "vlm" else "s"
    assert seq == want_seq
    assert flash[0].invals[0].dims[3] == cfg.resolved_head_dim
    # the f32 plan selects the mma kernel at hd 16 / 12 on every layer
    sels = {s.variant.name for s in opt.plan.kernel_selections.values()
            if s.prim_name == "flash_attention"}
    assert sels == {"mma_f32_bq64_bkv64"}


# -- decode -------------------------------------------------------------------------


def _decode_inp(cfg, rng, b):
    if cfg.input_mode == "embeddings":
        return {"frame_embed": rng.randn(b, 1, cfg.d_model).astype(np.float32)}
    return {"token": rng.randint(0, cfg.vocab, (b, 1)).astype(np.int32)}


@pytest.mark.parametrize("arch", ["musicgen_medium", "internvl2_2b"])
def test_decode_step_matches_the_reference_from_a_mid_stream_cache(arch):
    from repro.models import decode_step as jdecode
    from repro.models import init_cache as jinit_cache
    cfg = get_smoke_config(arch)
    jcfg, jparams, params = _weights(cfg)
    b, prompt, more, max_len = 2, 5, 4, 12
    rng = np.random.RandomState(31)
    inps = [_decode_inp(cfg, rng, b) for _ in range(prompt + more)]
    jstep = jax.jit(lambda p, s, i: jdecode(jcfg, p, s, i))
    jstate = jinit_cache(jcfg, b, max_len=max_len)
    for inp in inps[:prompt]:
        _, jstate = jstep(jparams, jstate, _jax(inp))
    state = cache_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                           device="cpu")
    step = make_serve_step(cfg)
    for inp in inps[prompt:]:
        jlogits, jstate = jstep(jparams, jstate, _jax(inp))
        logits, state = step(params, state, _torch(inp))
        assert logits.shape == jlogits.shape
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL)
    assert [int(c.kv.length) for c in state.caches] == \
        [prompt + more] * cfg.n_layers


def test_decode_over_frames_matches_forward():
    cfg = get_smoke_config("musicgen_medium")
    params = init_params(cfg, seed=0, device="cpu")
    b, s = 2, 10
    frames = torch.from_numpy(_batch(cfg, b, s, 4, labels=False)
                              ["frame_embed"])
    full = forward(cfg, params, {"frame_embed": frames})
    state = init_cache(cfg, b, max_len=s + 2, device="cpu")
    outs = []
    for t in range(s):
        lg, state = decode_step(cfg, params, state,
                                {"frame_embed": frames[:, t:t + 1]})
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    assert dec.shape == full.shape == (b, s, cfg.n_codebooks,
                                       cfg.padded_vocab)
    rel = (dec - full).abs().max().item() / full.abs().max().item()
    assert rel < 2e-2, f"decode/forward mismatch rel={rel}"


def test_serve_in_embeddings_mode_equals_a_hand_written_loop():
    cfg = get_smoke_config("musicgen_medium")
    params = init_params(cfg, seed=0, device="cpu")
    batch, prompt_len, gen = 2, 5, 4
    out = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=0,
                device="cpu")
    assert out["tokens"].shape == (batch, gen, cfg.n_codebooks)
    prompt = np.random.RandomState(0).randn(
        batch, prompt_len, cfg.d_model).astype(np.float32)
    np.testing.assert_array_equal(out["prompt"], prompt)
    state = init_cache(cfg, batch, prompt_len + gen + 1, device="cpu")
    frames = torch.from_numpy(prompt)
    for t in range(prompt_len):
        logits, state = decode_step(cfg, params, state,
                                    {"frame_embed": frames[:, t:t + 1]})
    assert torch.equal(logits, out["prompt_logits"])
    want = []
    for _ in range(gen):
        want.append(logits[:, -1].argmax(-1).numpy())
        logits, state = decode_step(
            cfg, params, state,
            {"frame_embed": torch.zeros(batch, 1, cfg.d_model)})
    np.testing.assert_array_equal(out["tokens"], np.stack(want, axis=1))
    assert int(out["state"].caches[-1].kv.length) == prompt_len + gen


# -- specs ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_specs_equal_the_reference(arch):
    from repro.configs import get_smoke_config as jsmoke
    from repro.launch import specs as RS
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    for b, s in ((2, 24), (1, 9)):
        want = RS.batch_specs(jcfg, b, s)
        got = batch_specs(cfg, b, s)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert {k: str(v.dtype).split(".")[-1] for k, v in got.items()} == \
            {k: str(v.dtype) for k, v in want.items()}
    dec, jdec = decode_input_specs(cfg, 3), RS.decode_input_specs(jcfg, 3)
    assert {k: tuple(v.shape) for k, v in dec.items()} == \
        {k: tuple(v.shape) for k, v in jdec.items()}
    B, S = symbolic_dims("b, s")
    sym = batch_specs(cfg, B, S)
    text = "frame_embed" if cfg.input_mode == "embeddings" else "tokens"
    assert sym[text].shape[:2] == (B, S)


# -- the flash route rule ----------------------------------------------------------------


def test_the_route_rule_and_the_ops_named_variants():
    """bf16 takes the sm90 kernel at its head dims and the mma kernel at
    every other; a variant name the rule would route elsewhere raises,
    on the CPU too, where the names run the plain version."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import route_of
    assert [route_of(torch.bfloat16, hd) for hd in (12, 16, 48, 32, 256)] \
        == ["mma", "mma", "mma", "sm90", "sm90"]
    assert {route_of(torch.float32, hd) for hd in (12, 128, 256)} == {"mma"}
    rng = np.random.RandomState(5)
    for hd, good, bad in ((16, "mma_bf16_bq64_bkv64", "sm90_bm128_bn128"),
                          (32, "sm90_bm128_bn128", "mma_bf16_bq64_bkv64")):
        q, k, v = (torch.from_numpy(rng.randn(1, 2, 9, hd).astype(
            np.float32)).to(torch.bfloat16) for _ in range(3))
        assert torch.equal(flash_attention(q, k, v, True, None, good),
                           flash_attention(q, k, v, True, None, "ref"))
        with pytest.raises(ValueError, match=f"head dim {hd}"):
            flash_attention(q, k, v, True, None, bad)


# -- attention at hd 12 and 16 ---------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 6, 2, 40, 40, 12),
                                   (2, 4, 2, 100, 100, 16),
                                   (1, 4, 4, 17, 17, 16),
                                   (1, 6, 3, 24, 64, 12)], ids=str)
def test_plain_attention_at_hd12_and_16_equals_the_pallas_kernel(shape,
                                                                 causal):
    from repro.kernels.ops import flash_attention as jflash
    b, hq, hkv, s, t, hd = shape
    rng = np.random.RandomState(sum(shape))
    q, k, v = (rng.randn(*d).astype(np.float32)
               for d in ((b, hq, s, hd), (b, hkv, t, hd), (b, hkv, t, hd)))
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, interpret=True)
    got = reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
