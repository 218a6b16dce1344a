"""The port's launch tooling against the reference's.

* ``configs.cells_for`` and ``launch.specs``' ``params_specs`` /
  ``opt_specs`` / ``input_specs`` for every arch at full width and every
  ``SHAPES`` cell: the reference's ``eval_shape``s, leaf for leaf, through
  the stacking map (a port leaf inside ``k`` layer lists is the
  reference's stacked leaf with those ``k`` leading dims).
* ``launch.sharding.ShardingRules``: every params, cache and batch leaf's
  spec equal to the reference's on the (1,1), (16,16) and (2,16,16)
  meshes (the port's over a fake 512-rank world, the reference's a stub
  with ``shape`` and ``axis_names``), with the same ``fallbacks``; the
  DTensor placements of specs on the fake world.
* ``launch.graph_analysis``: FLOPs equal to the reference's
  ``HLOAnalyzer`` on the twins of ``tests/test_analysis_tools.py``'s scans
  (rolled and opaque, nested) and on the 1-layer smoke ``llama2_1b``: the
  prefill exactly, the train step plus the port's flash backward's
  recompute of QKᵀ (2·B·Hq·S·T·hd a layer).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ARCHS, SHAPES, cells_for, get_config
from repro_torch.core import TensorSpec, optimize, scan, spec_like, \
    symbolic_dims
from repro_torch.core.ir.loop import OpaqueScan, loop_body_of
from repro_torch.launch.graph_analysis import GraphAnalyzer, analyze_graph
from repro_torch.launch.mesh import (destroy_world, init_fake_world,
                                     make_debug_mesh, make_production_mesh)
from repro_torch.launch.sharding import P, ShardingRules, _leaves
from repro_torch.launch.specs import input_specs, opt_specs, params_specs

MESHES = {"1x1": (1, 1), "16x16": (16, 16), "2x16x16": (2, 16, 16)}
MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_world():
    """A fake 512-rank process group, destroyed after the test."""
    init_fake_world(512)
    yield
    destroy_world()


def _ref_cfg(arch):
    from repro.configs import get_config as ref_config
    return ref_config(arch)


def _ref_name(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in path)


def _ref_leaves(tree):
    """name -> leaf of a reference pytree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_ref_name(path): leaf for path, leaf in flat}


def _port_leaves(tree):
    """(stacked name, stack, leaf) of a port pytree, Nones dropped."""
    return [x for x in _leaves(tree)[0] if x[2] is not None]


def assert_same_specs(port, ref):
    """Every reference leaf is the port's leaves of that name stacked:
    the same shape with the stack in front, the same dtype, and as many
    port leaves as the stack holds."""
    ref = _ref_leaves(ref)
    seen = {}
    for name, stack, leaf in _port_leaves(port):
        assert name in ref, name
        want = ref[name]
        assert tuple(want.shape) == stack + tuple(leaf.shape), \
            (name, want.shape, stack, leaf.shape)
        assert str(leaf.dtype) == f"torch.{jnp.dtype(want.dtype).name}", \
            (name, leaf.dtype, want.dtype)
        seen[name] = seen.get(name, 0) + 1
        assert seen[name] <= int(np.prod(stack)), name
    assert seen == {n: int(np.prod(ref[n].shape[:len(s)]))
                    for n, s, _ in _port_leaves(port)}
    assert set(seen) == set(ref)


# -- cells and specs -------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_for_matches_the_reference(arch):
    from repro.configs import cells_for as ref_cells
    assert cells_for(get_config(arch)) == ref_cells(_ref_cfg(arch))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, shape):
    from repro.launch.specs import input_specs as ref_input_specs
    kind, specs = input_specs(get_config(arch), shape)
    ref_kind, ref_specs = ref_input_specs(_ref_cfg(arch), shape)
    assert kind == ref_kind and set(specs) == set(ref_specs)
    for key in specs:
        assert_same_specs(specs[key], ref_specs[key])


def test_params_and_opt_specs_allocate_nothing():
    """kimi_k2's 1T parameters and their moments, as specs, with no
    allocation: every tensor built on the meta device; as many as the
    reference's ``eval_shape`` holds."""
    from repro.launch.specs import params_specs as ref_params_specs
    cfg = get_config("kimi_k2_1t_a32b")
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() \
        else 0
    p = params_specs(cfg)
    o = opt_specs(cfg, p)
    n = sum(int(np.prod(s.shape)) for s in pytree.tree_leaves(p))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        ref_params_specs(_ref_cfg("kimi_k2_1t_a32b")))) > 10 ** 12
    assert o.step == TensorSpec((), torch.int32)
    moment = getattr(torch, cfg.optimizer_dtype)
    assert all(isinstance(s, TensorSpec) and s.dtype == moment
               for s in pytree.tree_leaves((o.m, o.v)))
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == before


# -- sharding rules --------------------------------------------------------------


def _ref_rules(dims):
    """The reference's rules over a stub mesh of ``dims``."""
    from repro.launch.sharding import ShardingRules as RefRules
    names = MESH_AXES[len(dims)]
    return RefRules(types.SimpleNamespace(shape=dict(zip(names, dims)),
                                          axis_names=names))


def _port_mesh(dims):
    if len(dims) == 3:
        return make_production_mesh(multi_pod=True, device="cpu")
    if dims == (16, 16):
        return make_production_mesh(device="cpu")
    return make_debug_mesh(*dims, device="cpu")


def _ref_specs(ref_specs):
    """name -> spec entries of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        ref_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {_ref_name(path): tuple(spec) for path, spec in flat}


def assert_same_pspecs(port_specs, port_tree, ref_specs):
    """Each port leaf's spec is the reference's stacked leaf's with the
    stacked entries dropped."""
    ref = _ref_specs(ref_specs)
    specs = pytree.tree_leaves(port_specs,
                               is_leaf=lambda x: isinstance(x, P))
    leaves = _leaves(port_tree)[0]
    assert len(specs) == len(leaves)
    for spec, (name, stack, leaf) in zip(specs, leaves):
        if leaf is None:
            assert spec is None
            continue
        assert isinstance(spec, P) and len(spec) == len(leaf.shape)
        assert tuple(spec) == ref[name][len(stack):], (name, spec, ref[name])


def _cell_inputs(cfg, shape):
    """``input_specs`` without the parameters."""
    from repro_torch.launch import specs as m
    cell = SHAPES[shape]
    b, s = cell["global_batch"], cell["seq_len"]
    if cell["kind"] != "decode":
        return cell["kind"], {"batch": m.batch_specs(cfg, b, s)}
    return "decode", {"state": m.cache_specs(cfg, b, s),
                      "inp": m.decode_input_specs(cfg, b)}


def _ref_cell_inputs(cfg, shape):
    from repro.launch import specs as m
    cell = SHAPES[shape]
    b, s = cell["global_batch"], cell["seq_len"]
    if cell["kind"] != "decode":
        return cell["kind"], {"batch": m.batch_specs(cfg, b, s)}
    return "decode", {"state": m.cache_specs(cfg, b, s),
                      "inp": m.decode_input_specs(cfg, b)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_rules_match_the_reference(fake_world, arch, mesh):
    """Params, every decode cell's cache and every cell's batch: the same
    specs, and the params' fallbacks equal the reference's record."""
    dims = MESHES[mesh]
    cfg, ref_cfg = get_config(arch), _ref_cfg(arch)
    rules, ref_rules = ShardingRules(_port_mesh(dims)), _ref_rules(dims)
    assert (rules.model, rules.data, rules.dp) == \
        (ref_rules.model, ref_rules.data, ref_rules.dp)
    from repro.launch.specs import params_specs as ref_params_specs
    p = params_specs(cfg)
    ref_p = ref_params_specs(ref_cfg)
    assert_same_pspecs(rules.params_pspecs(p), p,
                       ref_rules.params_pspecs(ref_p))
    assert rules.fallbacks == ref_rules.fallbacks
    FALLBACKS[arch, mesh] = dict(rules.fallbacks)
    for shape in SHAPES:
        kind, specs = _cell_inputs(cfg, shape)
        _, ref_specs = _ref_cell_inputs(ref_cfg, shape)
        key = "batch" if kind != "decode" else "inp"
        assert_same_pspecs(rules.batch_specs(specs[key]), specs[key],
                           ref_rules.batch_specs(ref_specs[key]))
        if kind == "decode":
            assert_same_pspecs(rules.cache_specs(specs["state"]),
                               specs["state"],
                               ref_rules.cache_specs(ref_specs["state"]))


FALLBACKS = {}


def test_fallbacks_were_recorded():
    """The comparison above met fallbacks, none on the 1x1 mesh: the
    16-way model axis divides neither the MoE archs' 61 stacked layers
    (their shared FFN, 3-D once stacked, takes the expert rule) nor
    xlstm's 4 heads."""
    assert len(FALLBACKS) == 3 * len(ARCHS)
    assert not any(FALLBACKS[a, "1x1"] for a in ARCHS)
    assert any(FALLBACKS[a, "16x16"] for a in ARCHS)


def test_moe_shared_ffn_spec_reads_the_stacked_shape(fake_world):
    """deepseek_v3's shared FFN is 2-D a layer and 3-D once stacked, so
    the reference's expert rule applies to it: the port's spec is that
    rule's with the layer entry dropped, not the dense FFN's."""
    rules = ShardingRules(make_production_mesh(device="cpu"))
    cfg = get_config("deepseek_v3_671b")
    p = params_specs(cfg)
    layer = next(i for i, lp in enumerate(p["layers"]) if "moe" in lp)
    shared = p["layers"][layer]["moe"]["shared"]["w1"]
    name = "layers/moe/shared/w1"
    stacked = rules.spec_for(name, shared.shape, (cfg.n_layers,))
    assert stacked == rules._stacked_spec(
        name, (cfg.n_layers,) + shared.shape)[1:]
    assert stacked != rules.spec_for("layers/ffn/w1", shared.shape)


def test_placements_on_a_fake_16x16_world(fake_world):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = make_production_mesh(device="cpu")
    rules = ShardingRules(mesh)
    assert rules.placements(P("data", "model")) == (Shard(0), Shard(1))
    assert rules.placements(P("model", None)) == (Replicate(), Shard(0))
    assert rules.placements(P(None, "data")) == (Shard(1), Replicate())
    assert rules.placements(P()) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="twice"):
        rules.placements(P("data", "data"))
    pod = ShardingRules(make_production_mesh(multi_pod=True, device="cpu"))
    assert pod.placements(P(("pod", "data"), "model")) == \
        (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="order"):
        pod.placements(P(("data", "pod")))
    # llama2_1b's weights as NamedShardings; rank 0's DTensor shard of
    # the embedding is its 1/16 of the vocab, whole in D
    p = params_specs(get_config("llama2_1b"))
    named = rules.named(rules.params_pspecs(p))
    emb = named["embed"]
    assert emb.mesh is mesh and emb.spec == P("model", None)
    assert emb.placements == (Replicate(), Shard(0))
    x = torch.arange(32 * 4, dtype=torch.float32).reshape(32, 4)
    d = distribute_tensor(x, mesh, emb.placements, src_data_rank=None)
    assert torch.equal(d.to_local(), x[:2])


def test_a_mesh_bigger_than_the_world_names_what_is_missing(fake_world):
    with pytest.raises(ValueError, match="1024 ranks; the world has 512: "
                                         "512 missing"):
        make_debug_mesh(32, 32, device="cpu")


def test_a_mesh_without_a_world_says_how_to_start_one():
    with pytest.raises(RuntimeError, match="init_fake_world"):
        make_production_mesh(device="cpu")


# -- the graph analyzer ----------------------------------------------------------


def _chain(x, xs, w):
    def body(c, xi):
        return c @ w, xi
    return scan(body, x, xs)[0]


def _nested(x, xo, xi, w):
    def inner(c, z):
        return c @ w, z

    def outer(c, z):
        return scan(inner, c, xi)[0], z
    return scan(outer, x, xo)[0]


def _ref_hlo_flops(fn, *args):
    from repro.launch.hlo_analysis import HLOAnalyzer
    return HLOAnalyzer(jax.jit(fn).lower(*args).compile().as_text()
                       ).analyze()["flops"]


@pytest.mark.parametrize("length", ["static", "symbolic"])
def test_scan_flops_scale_by_trips_as_the_reference(length):
    """tests/test_analysis_tools.py's scan of 17 matmuls: an opaque node
    (static length) and a rolled loop (symbolic), both 2·64³·17."""
    w = jnp.ones((64, 64), jnp.float32)

    def ref(x):
        return jax.lax.scan(lambda c, _: (c @ w, None), x, None,
                            length=17)[0]

    want = _ref_hlo_flops(ref, jnp.ones((64, 64), jnp.float32))
    t = symbolic_dims("t")[0] if length == "symbolic" else 17
    f32 = torch.float32
    opt = optimize(_chain, TensorSpec((64, 64), f32), TensorSpec((t, 1), f32),
                   TensorSpec((64, 64), f32), device="cpu")
    [node] = opt.plan.graph.nodes
    assert (loop_body_of(node) is not None) == (length == "symbolic")
    assert isinstance(node.prim, OpaqueScan) == (length == "static")
    an = GraphAnalyzer(opt.plan.graph, {"t": 17})
    got = an.analyze()
    assert got["flops"] == want == 2 * 64 ** 3 * 17
    assert not an.warnings and got["n_warnings"] == 0
    assert got["collective_bytes"] == 0


@pytest.mark.parametrize("length", ["static", "symbolic"])
def test_nested_scan_flops_multiply_as_the_reference(length):
    w = jnp.ones((32, 32), jnp.float32)

    def ref(x):
        def inner(c, _):
            return c @ w, None

        def outer(c, _):
            return jax.lax.scan(inner, c, None, length=5)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]

    want = _ref_hlo_flops(ref, jnp.ones((32, 32), jnp.float32))
    a, b = symbolic_dims("a, b") if length == "symbolic" else (3, 5)
    f32 = torch.float32
    opt = optimize(_nested, TensorSpec((32, 32), f32),
                   TensorSpec((a, 1), f32), TensorSpec((b, 1), f32),
                   TensorSpec((32, 32), f32), device="cpu")
    got = analyze_graph(opt.plan.graph, {"a": 3, "b": 5})
    assert got["flops"] == want == 2 * 32 ** 3 * 15
    assert got["n_warnings"] == 0


SMOKE_AT = [(2, 16), (3, 29)]


@pytest.fixture(scope="module")
def smoke_1layer():
    """The smoke llama2_1b cut to 1 layer: the port's config and weights
    and the reference's config, weights and AdamW state."""
    from repro.configs import get_smoke_config as ref_smoke
    from repro.launch.steps import adamw_config_for as ref_adamw
    from repro.models import init_params as ref_init
    from repro.optim import init_state as ref_state
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    jcfg = dataclasses.replace(ref_smoke("llama2_1b"), n_layers=1,
                               scan_layers=False)
    cfg = dataclasses.replace(get_smoke_config("llama2_1b"), n_layers=1)
    jp = ref_init(jcfg, jax.random.PRNGKey(0))
    return (cfg, init_params(cfg, 0, device="cpu"), jcfg, jp,
            ref_state(jp, ref_adamw(jcfg)))


def test_prefill_flops_equal_the_reference(smoke_1layer):
    from repro.launch.steps import make_prefill_step as ref_prefill
    from repro_torch.launch.steps import make_prefill_step
    cfg, params, jcfg, jp, _ = smoke_1layer
    b, s = symbolic_dims("b, s")
    opt = optimize(make_prefill_step(cfg), spec_like(params),
                   {"tokens": TensorSpec((b, s), torch.int32)},
                   device="cpu")
    names = {n.prim_name for n in opt.plan.graph.nodes}
    assert "repro_torch.flash_attention.default" in names
    for bb, ss in SMOKE_AT:
        tok = jnp.zeros((bb, ss), jnp.int32)
        want = _ref_hlo_flops(ref_prefill(jcfg), jp, {"tokens": tok})
        got = analyze_graph(opt.plan.graph, {"b": bb, "s": ss})
        assert got["flops"] == want, (bb, ss)
        assert got["hbm_bytes"] > 0 and got["transcendentals"] > 0


def test_train_flops_equal_the_reference_plus_the_qk_recompute(
        smoke_1layer):
    """The reference's dense attention backward reuses its forward's
    probabilities; the port's flash backward (``kernels/ops.py``
    ``_flash_backward``) recomputes them from q and k: one more QKᵀ,
    2·B·Hq·S·T·hd a layer.  Nothing else differs."""
    from repro.launch.steps import make_train_step as ref_train
    from repro_torch.launch.steps import adamw_config_for, make_train_step
    from repro_torch.optim import init_state
    cfg, params, jcfg, jp, jo = smoke_1layer
    b, s = symbolic_dims("b, s")
    opt = optimize(make_train_step(cfg), spec_like(params),
                   spec_like(init_state(params, adamw_config_for(cfg))),
                   {"tokens": TensorSpec((b, s), torch.int32),
                    "labels": TensorSpec((b, s), torch.int32)},
                   device="cpu")
    hd = cfg.resolved_head_dim
    for bb, ss in SMOKE_AT:
        tok = jnp.zeros((bb, ss), jnp.int32)
        want = _ref_hlo_flops(ref_train(jcfg), jp, jo,
                              {"tokens": tok, "labels": tok})
        got = analyze_graph(opt.plan.graph, {"b": bb, "s": ss})
        recompute = 2 * bb * cfg.n_heads * ss * ss * hd * cfg.n_layers
        assert got["flops"] == want + recompute, (bb, ss)
