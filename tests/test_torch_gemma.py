"""gemma on the port against the reference, on the CPU.

* the ``gemma_2b``/``gemma_7b`` configs equal the reference's;
* GeGLU equals the reference's ``ffn_apply(kind="geglu")``;
* the plain attention at head dim 256 (MQA, ragged S, S < T) equals the
  Pallas kernel in interpret mode;
* the gemma prefill equals the reference's ``prefill`` at the smoke
  width (hd 32) and at hd 256, eagerly and through one ``optimize`` plan;
* the selector picks the sm90 kernel's hd-256 instance for bf16 and the
  mma kernel for f32, and the mma kernel at hd 12, 16 and 48 in both
  dtypes, which the sm90 kernel still refuses;
* ``decode_step`` equals the reference's token by token from a
  mid-stream cache (``cache_from_jax``), for gemma and llama;
* decode over a prompt equals the full forward (the reference's
  ``test_decode_matches_forward`` measure);
* ``serve`` returns the reference's keys, and its tokens equal a decode
  loop written out by hand on the same weights; in embeddings mode
  (musicgen) it decodes frames into one token per codebook;
* no file of the port, nor ``chip_smoke.py``, imports ``jax`` or the
  reference package.

Inputs are made with numpy from a seed; f32 is held to 2e-4.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import (ARCHS, gemma_2b, gemma_7b, llama2_1b,
                                 musicgen_medium)
from repro_torch.core import TensorSpec, optimize, spec_like, symbolic_dims
from repro_torch.kernels import reference_attention
from repro_torch.kernels import variants as V
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import (cache_from_jax, decode_step, forward,
                                init_cache, init_params, params_from_jax,
                                prefill)
from repro_torch.models.ffn import ffn_apply, geglu

TOL = 2e-4
GEMMA_SMOKE = gemma_2b.SMOKE
GEMMA_HD256 = dataclasses.replace(GEMMA_SMOKE, head_dim=256)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(cfg):
    """The reference's smoke config of the same name, at cfg's head dim."""
    from repro.configs import gemma_2b as jgemma
    from repro.configs import llama2_1b as jllama
    ref = {"gemma2b-smoke": jgemma.SMOKE, "llama2-smoke": jllama.SMOKE}[
        cfg.name]
    return dataclasses.replace(ref, head_dim=cfg.head_dim)


def _weights(cfg, seed=0):
    """Reference weights (numpy) and the port's copy of them."""
    from repro.models import init_params as jinit
    jcfg = _jax_cfg(cfg)
    jparams = jinit(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, params_from_jax(np_params, cfg, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab,
                                               (b, s)).astype(np.int32)


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("module", ["gemma_2b", "gemma_7b"])
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_configs_equal_the_reference(module, which):
    import importlib
    ref = getattr(importlib.import_module(f"repro.configs.{module}"), which)
    port = getattr({"gemma_2b": gemma_2b, "gemma_7b": gemma_7b}[module],
                   which)
    shared = {f.name for f in dataclasses.fields(port)} & \
        {f.name for f in dataclasses.fields(ref)}
    assert {n: getattr(port, n) for n in shared} == \
        {n: getattr(ref, n) for n in shared}
    assert port.param_count() == ref.param_count()
    assert module in ARCHS
    if (module, which) == ("gemma_2b", "CONFIG"):
        assert port.param_count() == 2_506_096_640
        assert port.padded_vocab == port.vocab == 256_000


# -- GeGLU --------------------------------------------------------------------


def test_geglu_matches_the_reference():
    from repro.models.ffn import ffn_apply as jffn
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 64).astype(np.float32)
    w = {"w1": rng.randn(64, 128).astype(np.float32) / 8,
         "w3": rng.randn(64, 128).astype(np.float32) / 8,
         "w2": rng.randn(128, 64).astype(np.float32) / 11}
    want = np.asarray(jffn({k: jnp.asarray(v) for k, v in w.items()},
                           jnp.asarray(x), kind="geglu"))
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got = ffn_apply(tw, torch.from_numpy(x), kind="geglu")
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert torch.equal(got, geglu(torch.from_numpy(x), tw["w1"], tw["w3"],
                                  tw["w2"]))
    with pytest.raises(NotImplementedError, match="relu"):
        ffn_apply(tw, torch.from_numpy(x), kind="relu")


# -- attention at head dim 256 -------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 8, 1, 100, 100, 256),
                                   (2, 4, 1, 64, 64, 256),
                                   (1, 4, 2, 48, 80, 256)], ids=str)
def test_attention_at_hd256_matches_the_pallas_kernel(shape, causal):
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


# -- prefill --------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [GEMMA_SMOKE, GEMMA_HD256],
                         ids=["hd32", "hd256"])
def test_gemma_prefill_matches_the_reference(cfg):
    from repro.models import forward as jforward
    from repro.models import prefill as jprefill
    jcfg, jparams, params = _weights(cfg)
    toks = _tokens(cfg, 2, 24, 5)
    want = np.asarray(jprefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}))
    got = prefill(cfg, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    jfull, _ = jforward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    full = forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("cfg", [GEMMA_SMOKE, GEMMA_HD256],
                         ids=["hd32", "hd256"])
def test_gemma_prefill_through_one_plan_matches_the_reference(
        cfg, monkeypatch):
    import repro_torch.core.api as api
    from repro.models import prefill as jprefill
    jcfg, jparams, params = _weights(cfg)
    captures = []
    real = api.capture
    monkeypatch.setattr(api, "capture",
                        lambda *a, **kw: captures.append(1) or real(*a, **kw))
    B, S = symbolic_dims("b, s")
    opt = optimize(make_prefill_step(cfg), spec_like(params),
                   {"tokens": TensorSpec((B, S), torch.int32)},
                   dynamic_dims={"b": (1, 4), "s": (1, 64)}, device="cpu")
    for i, (b, s) in enumerate([(1, 1), (2, 17), (4, 64)]):
        toks = _tokens(cfg, b, s, 10 + i)
        want = np.asarray(jprefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(toks)}))
        got = opt(params, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        st = opt.last_report.stats
        assert st.device_peak <= opt.guaranteed_peak_bytes
        assert st.arena_bytes <= opt.arena_bound_bytes
    assert len(captures) == 1
    # every attention node of the plan is a flash-attention kernel node
    prims = [n.prim_name for n in opt.plan.graph.nodes]
    assert prims.count("repro_torch.flash_attention.default") == \
        cfg.n_layers
    assert prims.count("repro_torch.rmsnorm.default") == 2 * cfg.n_layers + 1


# -- the selector at hd 256 -----------------------------------------------------


def test_the_selector_takes_hd256_and_still_refuses_hd48():
    full = gemma_2b.CONFIG
    bounds = {"b": (1, 8), "hq": (8, 8), "hkv": (1, 1), "s": (16, 1024),
              "t": (16, 1024), "hd": (256, 256)}
    hi = {k: h for k, (_lo, h) in bounds.items()}
    assert full.resolved_head_dim == 256 and full.n_kv_heads == 1
    assert V.variant_valid("flash_attention", V.SM90, hi, torch.bfloat16)
    assert V.variant_smem_bytes("flash_attention", V.SM90, hi) == 197_696
    assert V.variant_block(V.SM90, hi) == {"block_kv": 64, "block_q": 128}
    bf16, scores, _p, invalid = V.select_variant(
        "flash_attention", bounds, torch.bfloat16, {"causal": True})
    assert bf16 is V.SM90 and V.SM90.name not in invalid
    assert V.default_variant("flash_attention", torch.bfloat16) is bf16
    f32, _s, _p, _i = V.select_variant("flash_attention", bounds,
                                       torch.float32, {"causal": True})
    assert f32 is V.MMA_F32
    # hd 12, 16 and 48: the sm90 kernel still refuses them, the mma
    # kernel takes them in both dtypes (hd 12 in its 16 instance, 48 in
    # its own), over the whole range where the plain version cannot serve
    for hd in (12, 16, 48):
        for dtype, want in ((torch.bfloat16, V.MMA_BF16),
                            (torch.float32, V.MMA_F32)):
            got, _s, _p, invalid = V.select_variant(
                "flash_attention", dict(bounds, hd=(hd, hd)), dtype,
                {"causal": True})
            assert got is want, (hd, dtype)
            if dtype == torch.bfloat16:
                assert f"head dim {hd}" in invalid[V.SM90.name]
            assert "max_transient_bytes" in invalid[V.REF_DENSE.name]
            assert V.default_variant("flash_attention", dtype,
                                     {"hd": hd}) is want
    # hd 12 runs in the 16 instance: (64 + 4 x 64) rows of 16 columns and
    # a 16-byte pad, 2 bytes each in bf16 and 4 in f32
    assert V.variant_smem_bytes("flash_attention", V.MMA_BF16,
                                {"hd": 12}) == 320 * 24 * 2 == 15_360
    assert V.variant_smem_bytes("flash_attention", V.MMA_F32,
                                {"hd": 16}) == 320 * 20 * 4 == 25_600
    assert "bfloat16 takes the sm90" in V.variant_invalid_reason(
        "flash_attention", V.MMA_BF16, hi, torch.bfloat16)
    with pytest.raises(ValueError, match="no valid"):
        V.select_variant("flash_attention", dict(bounds, hd=(320, 320)),
                         torch.bfloat16, {"causal": True})


def test_a_plan_at_hd256_selects_the_sm90_hd256_instance():
    cfg = dataclasses.replace(GEMMA_HD256, dtype="bfloat16")
    params = init_params(cfg, seed=0, device="cpu")
    B, S = symbolic_dims("b, s")
    opt = optimize(make_prefill_step(cfg), spec_like(params),
                   {"tokens": TensorSpec((B, S), torch.int32)},
                   dynamic_dims={"b": (1, 8), "s": (16, 1024)},
                   device="cpu")
    sels = [s for s in opt.plan.kernel_selections.values()
            if s.prim_name == "flash_attention"]
    assert len(sels) == cfg.n_layers
    assert all(s.variant is V.SM90 and s.is_default for s in sels)
    # the decision records the tiles of the hd-256 instance
    logged = [d for d in opt.decisions.entries("kernel-select")
              if "flash_attention" in d.subject]
    assert [(d.choice, d.detail["block"]) for d in logged] == \
        [(V.SM90.name, {"block_kv": 64, "block_q": 128})] * cfg.n_layers


# -- decode ---------------------------------------------------------------------


def _jax_state_np(state):
    return jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("cfg", [GEMMA_SMOKE, llama2_1b.SMOKE],
                         ids=["gemma", "llama"])
def test_decode_step_matches_the_reference_from_a_mid_stream_cache(cfg):
    from repro.models import decode_step as jdecode
    from repro.models import init_cache as jinit_cache
    jcfg, jparams, params = _weights(cfg)
    b, prompt, more, max_len = 2, 5, 4, 12
    toks = _tokens(cfg, b, prompt + more, 21)
    jstep = jax.jit(lambda p, s, i: jdecode(jcfg, p, s, i))
    jstate = jinit_cache(jcfg, b, max_len=max_len)
    for t in range(prompt):
        _, jstate = jstep(jparams, jstate, {"token": jnp.asarray(
            toks[:, t:t + 1])})
    state = cache_from_jax(_jax_state_np(jstate), cfg, device="cpu")
    assert [int(c.kv.length) for c in state.caches] == [prompt] * cfg.n_layers
    step = make_serve_step(cfg)
    for t in range(prompt, prompt + more):
        tok = toks[:, t:t + 1]
        jlogits, jstate = jstep(jparams, jstate, {"token": jnp.asarray(tok)})
        logits, state = step(params, state, {"token": torch.from_numpy(tok)})
        assert tuple(logits.shape) == (b, 1, cfg.vocab)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL)
    want = cache_from_jax(_jax_state_np(jstate), cfg, device="cpu")
    for got_c, want_c in zip(state.caches, want.caches):
        assert int(got_c.kv.length) == int(want_c.kv.length) == prompt + more
        for name in ("k", "v"):
            np.testing.assert_allclose(getattr(got_c.kv, name).numpy(),
                                       getattr(want_c.kv, name).numpy(),
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cfg", [GEMMA_SMOKE, GEMMA_HD256, llama2_1b.SMOKE],
                         ids=["gemma", "gemma-hd256", "llama"])
def test_decode_over_a_prompt_matches_forward(cfg):
    params = init_params(cfg, seed=0, device="cpu")
    b, s = 2, 12
    toks = torch.from_numpy(_tokens(cfg, b, s, 4))
    full = forward(cfg, params, {"tokens": toks})
    state = init_cache(cfg, b, max_len=s + 4, device="cpu")
    k_buf = state.caches[0].kv.k
    outs = []
    for t in range(s):
        lg, state = decode_step(cfg, params, state,
                                {"token": toks[:, t:t + 1]})
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    rel = (dec - full).abs().max().item() / max(full.abs().max().item(),
                                                1e-6)
    assert rel < 2e-2, f"decode/forward mismatch rel={rel}"
    # the cache was written out of place, as the reference's is: the first
    # layer's buffer init_cache made is untouched
    assert state.caches[0].kv.k is not k_buf
    assert not k_buf.any()
    assert int(state.caches[0].kv.length) == s


def test_serve_returns_the_reference_keys_and_a_hand_written_decode():
    cfg = GEMMA_SMOKE
    params = init_params(cfg, seed=0, device="cpu")
    batch, prompt_len, gen = 2, 6, 5
    out = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=0,
                device="cpu")
    assert {"prefill_s", "decode_s", "decode_tok_per_s",
            "tokens"} <= set(out)
    assert out["tokens"].shape == (batch, gen)
    assert int(out["state"].caches[-1].kv.length) == prompt_len + gen
    # the same loop written out: weights from seed 0, the prompt from
    # RandomState(0)
    prompt = np.random.RandomState(0).randint(1, cfg.vocab,
                                              (batch, prompt_len))
    np.testing.assert_array_equal(out["prompt"], prompt)
    state = init_cache(cfg, batch, prompt_len + gen + 1, device="cpu")
    toks = torch.from_numpy(prompt).to(torch.int32)
    for t in range(prompt_len):
        logits, state = decode_step(cfg, params, state,
                                    {"token": toks[:, t:t + 1]})
    assert torch.equal(logits, out["prompt_logits"])
    want = []
    for _ in range(gen):
        nxt = logits[:, -1].argmax(-1)
        want.append(nxt.numpy())
        logits, state = decode_step(cfg, params, state,
                                    {"token": nxt[:, None].to(torch.int32)})
    np.testing.assert_array_equal(out["tokens"], np.stack(want, axis=1))
    # embeddings mode (musicgen): frames in, the argmax of each codebook
    music = musicgen_medium.SMOKE
    out = serve(music, batch=batch, prompt_len=prompt_len, gen=gen, seed=0,
                device="cpu")
    assert {"prefill_s", "decode_s", "decode_tok_per_s",
            "tokens"} <= set(out)
    assert out["tokens"].shape == (batch, gen, music.n_codebooks)
    assert out["prompt"].shape == (batch, prompt_len, music.d_model)
    assert tuple(out["prompt_logits"].shape) == \
        (batch, 1, music.n_codebooks, music.padded_vocab)
    assert int(out["state"].caches[-1].kv.length) == prompt_len + gen


def test_the_port_and_chip_smoke_import_neither_jax_nor_the_reference():
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py")) + \
        [root / "chip_smoke.py"]
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)\b"
                         r"(?!_)", re.M)
    bad = [(f.name, m.group(0).strip()) for f in files
           for m in pattern.finditer(f.read_text())]
    assert len(files) > 60 and not bad, bad
