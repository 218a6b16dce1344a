"""``serve``'s decode step as one compiled plan, against the eager step
and the reference, on the CPU.

``launch.serve.decode_plan`` captures ``decode_step`` once with the batch
``b`` symbolic in [1, 8], a 49-row cache (``cache_specs``) and the
weights as arguments, as ``serve`` does before its prefill.  For each
family ``serve`` takes (dense tokens, gemma, embeddings, vlm, MoE with GQA
and with MLA, hybrid, xLSTM), at its smoke config in f32:

* one plan, no guards, and its logits and every state leaf bitwise equal
  to the eager ``decode_step`` at b = 1, 3, 8 from a cache 17 steps in;
* the call's ``device_peak`` within ``guaranteed_peak_bytes``;
* the VM and the op-by-op interpreter bitwise equal on the program;
* ``cache_specs`` leaf for leaf against the reference's (its stacked layer
  axis mapped to the port's per-layer lists);
* ``serve`` against the reference's ``serve`` (``jax.jit``) on the
  reference's weights carried across by ``models/convert.py``: equal
  tokens, the prompt's last logits within 2e-4.

And ``optimize`` takes ``None`` inside an argument or output pytree as an
empty subtree, as the reference's does: same output, same plan
statistics, the reference's graph bridged into the port's planner.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import TensorSpec, optimize, spec_like, symbolic_dims
from repro_torch.core.ir.capture import tree_flatten
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import decode_plan, serve
from repro_torch.launch.specs import cache_specs, decode_input_specs
from repro_torch.models import (decode_step, init_cache, init_params,
                                params_from_jax)

ARCHS = ["llama2_1b", "gemma_2b", "musicgen_medium", "internvl2_2b",
         "kimi_k2_1t_a32b", "deepseek_v3_671b", "hymba_1p5b", "xlstm_1p3b"]
MAX_LEN = 49          # serve's default prompt + gen + 1
BATCHES = (1, 3, 8)
MID_STREAM = 17       # steps run before the compared one
TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def plan(request):
    """(cfg, params, the VM plan, the interpreter plan) of one family."""
    cfg = get_smoke_config(request.param)
    params = init_params(cfg, seed=0, device="cpu")
    vm = decode_plan(cfg, params, max_len=MAX_LEN, device="cpu")
    b, = symbolic_dims("b")
    interp = optimize(lambda p, s, i: decode_step(cfg, p, s, i),
                      spec_like(params), cache_specs(cfg, b, MAX_LEN),
                      decode_input_specs(cfg, b), dynamic_dims={"b": (1, 8)},
                      executor="reference", device="cpu")
    return cfg, params, vm, interp


def mid_stream(cfg, params, b):
    """A cache ``MID_STREAM`` eager steps in, and the next step's input,
    made with numpy from seed ``b``."""
    rng = np.random.RandomState(b)

    def inp():
        if cfg.input_mode == "embeddings":
            return {"frame_embed": torch.from_numpy(
                rng.randn(b, 1, cfg.d_model).astype(np.float32)).to(
                    cfg.torch_dtype)}
        return {"token": torch.from_numpy(
            rng.randint(1, cfg.vocab, (b, 1)).astype(np.int32))}

    state = init_cache(cfg, b, MAX_LEN, device="cpu")
    for _ in range(MID_STREAM):
        _, state = decode_step(cfg, params, state, inp())
    return state, inp()


def assert_bitwise(got, want):
    (g, g_tree), (w, w_tree) = tree_flatten(got), tree_flatten(want)
    assert g_tree == w_tree
    assert len(g) == len(w) > 0
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"leaf {i}"


def test_one_plan_is_the_eager_step_bitwise(plan):
    cfg, params, vm, _ = plan
    program = vm.program
    assert vm.report.guards == []
    assert vm.plan.graph.free_symbols() == {"b"}
    for b in BATCHES:
        state, inp = mid_stream(cfg, params, b)
        want = decode_step(cfg, params, state, inp)
        got = vm(params, state, inp)
        assert vm.program is program
        assert vm.last_report.env == {"b": b}
        assert_bitwise(got, want)
        lengths = {int(c.kv.length) for c in got[1].caches} \
            if got[1].caches is not None else {MID_STREAM + 1}
        assert lengths == {MID_STREAM + 1}


def test_device_peak_within_the_guarantee(plan):
    cfg, params, vm, _ = plan
    assert vm.guaranteed_peak_bytes is not None
    for b in BATCHES:
        state, inp = mid_stream(cfg, params, b)
        vm(params, state, inp)
        st = vm.last_report.stats
        assert 0 < st.device_peak <= vm.guaranteed_peak_bytes


def test_vm_equals_the_interpreter(plan):
    cfg, params, vm, interp = plan
    assert interp.program is None
    for b in (1, 3):
        state, inp = mid_stream(cfg, params, b)
        assert_bitwise(vm(params, state, inp), interp(params, state, inp))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch):
    """Leaf for leaf, shape and dtype: the reference stacks a layer axis
    (``(L, ...)``, an xLSTM group's mLSTM caches ``(G, M, ...)``) where the
    port keeps a list of layers."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.launch.specs import cache_specs as jcache_specs
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    b, = symbolic_dims("b")
    for batch in (3, b):
        got = cache_specs(cfg, batch, MAX_LEN)
        want = jcache_specs(jcfg, 3, MAX_LEN)

        def leaves(tree, lead):
            return [(tuple(3 if d is b else d for d in s.shape),
                     str(s.dtype).split(".")[-1])
                    for s in tree_flatten(tree)[0]] if lead is None else \
                [(tuple(a.shape[lead:]), str(a.dtype))
                 for a in jax.tree.leaves(tree)]

        if cfg.block_kind == "xlstm":
            assert got.caches is None and want.caches is None
            (m_got, s_got), (m_want, s_want) = got.xlstm, want.xlstm
            assert len(m_got) * len(m_got[0]) == \
                int(np.prod(jax.tree.leaves(m_want)[0].shape[:2]))
            for group in m_got:
                for cache in group:
                    assert leaves(cache, None) == leaves(m_want, 2)
            assert len(s_got) == jax.tree.leaves(s_want)[0].shape[0]
            for cache in s_got:
                assert leaves(cache, None) == leaves(s_want, 1)
            continue
        assert got.xlstm is None and want.xlstm is None
        assert len(got.caches) == cfg.n_layers
        for cache in got.caches:
            assert (cache.ssm is None) == (want.caches.ssm is None)
            assert type(cache.kv).__name__ == type(want.caches.kv).__name__
            assert leaves(cache, None) == leaves(want.caches, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_is_the_reference_serve(arch, monkeypatch):
    """The port's ``serve`` on the reference's weights (``params_from_jax``
    of its ``init_params`` at the same seed) against the reference's
    ``serve``, whose ``jax.jit`` step is wrapped to keep its logits: equal
    greedy tokens, the prompt's last logits within 2e-4; every step's
    arguments contiguous."""
    import repro.launch.serve as jserve_mod
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import init_params as jinit
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    batch, prompt_len, gen, seed = 2, 6, 5, 1
    jparams = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(seed)))
    monkeypatch.setattr(serve_mod, "init_params", lambda c, seed, device:
                        params_from_jax(jparams, c, device=device))
    calls = []

    def checked_plan(*args, **kw):
        """The plan, refusing an argument that is not contiguous: it was
        captured on contiguous ones, and the RMSNorm kernel takes no
        other (the plain version on the CPU would not notice)."""
        step = decode_plan(*args, **kw)

        def call(*a):
            calls.append(all(t.is_contiguous() for t in tree_flatten(a)[0]))
            return step(*a)
        return call

    monkeypatch.setattr(serve_mod, "decode_plan", checked_plan)
    got = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed,
                device="cpu")
    assert calls == [True] * (prompt_len + gen)

    logits = []
    jit = jax.jit

    def recording_jit(fn, **kw):
        step = jit(fn, **kw)

        def call(*args):
            out = step(*args)
            logits.append(np.asarray(out[0]))
            return out
        return call

    monkeypatch.setattr(jserve_mod.jax, "jit", recording_jit)
    want = jserve_mod.serve(jcfg, batch=batch, prompt_len=prompt_len,
                            gen=gen, seed=seed)
    assert len(logits) == prompt_len + gen
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["prompt_logits"].numpy(),
                               logits[prompt_len - 1], rtol=TOL, atol=TOL)
    assert got["compile_s"] > 0


def test_serve_raises_where_capture_refuses(monkeypatch):
    """No eager fallback: a step that capture refuses (here one reading a
    device value on the host) raises out of ``serve``, and the step is
    called once, by the capture, never by an eager loop."""
    cfg = get_smoke_config("llama2_1b")
    calls = []

    def host_read(c, p, s, i):
        calls.append(int(s.caches[0].kv.length))
        return decode_step(c, p, s, i)

    monkeypatch.setattr(serve_mod, "decode_step", host_read)
    with pytest.raises(Exception, match="data-dependent|Data dependent"):
        serve(cfg, batch=2, prompt_len=3, gen=2, device="cpu")
    assert calls == []


# -- None leaves -----------------------------------------------------------------


def _none_fn_port(x, d):
    return x * 2 + d["m"], None, {"y": x + 1, "z": None}


def _none_fn_ref(x, d):
    return x * 2 + d["m"], None, {"y": x + 1, "z": None}


def test_none_leaves_are_empty_subtrees_as_in_the_reference():
    from repro.core import optimize as joptimize
    from repro.core import symbolic_dims as jdims
    from repro_torch.core.api import _compile_pipeline as p_pipeline
    from repro_torch.core.symbolic import ShapeGraph, declare_dim_ranges
    from test_torch_planning import bridge

    ranges = {"b": (1, 8)}
    jb, = jdims("b")
    jspec = jax.ShapeDtypeStruct((jb, 4), jnp.float32)
    ref = joptimize(_none_fn_ref, jspec, {"n": None, "m": jspec},
                    dynamic_dims=ranges)
    b, = symbolic_dims("b")
    spec = TensorSpec((b, 4), torch.float32)
    port = optimize(_none_fn_port, spec, {"n": None, "m": spec},
                    dynamic_dims=ranges, device="cpu")
    rng = np.random.RandomState(0)
    for n in (1, 3):
        x, m = (rng.randn(n, 4).astype(np.float32) for _ in range(2))
        want = ref(jnp.asarray(x), {"n": None, "m": jnp.asarray(m)})
        got = port(torch.from_numpy(x), {"n": None, "m": torch.from_numpy(m)})
        assert got[1] is None and got[2]["z"] is None and want[1] is None
        assert tuple(got[0].shape) == want[0].shape == (n, 4)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[2]["y"].numpy(),
                                      np.asarray(want[2]["y"]))
    # both graphs take the two tensors and return the two: the Nones are
    # in neither
    for g in (ref.plan.graph, port.plan.graph):
        assert (len(g.inputs), len(g.outputs)) == (2, 2)
    # the reference's graph through the port's planner: its statistics
    sg = ShapeGraph()
    declare_dim_ranges(sg, ranges)
    _, rep, _ = p_pipeline(bridge(ref.plan.graph), sg, kernel_select=False)
    assert (rep.peak_bound_bytes, rep.arena_bound_bytes,
            rep.n_arena_slots) == \
        (ref.report.peak_bound_bytes, ref.report.arena_bound_bytes,
         ref.report.n_arena_slots)
    assert rep.peak_bound_bytes is not None
    # a call must pass the Nones where the trace had them
    with pytest.raises(TypeError, match="pytree structure"):
        port(torch.zeros(2, 4), {"n": torch.zeros(2, 4),
                                 "m": torch.zeros(2, 4)})
