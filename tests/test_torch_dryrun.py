"""The dry-run (``launch/dryrun.py``) against the reference's, on the CPU.

* skipped cells: every skipped ``(arch, shape, mesh)`` record equals the
  reference's ``run_cell`` record;
* argument bytes at full width: for every cell that runs, on the 16x16
  and 2x16x16 meshes, ``dryrun.argument_bytes`` (the local shards on a
  fake 512-rank world) equals the reference's per-device argument bytes,
  computed from its ``input_specs`` and its ``ShardingRules`` on a stub
  mesh (each sharded dim divided by its axes' sizes), without tracing;
* the analyzer on a toy DTensor product on a fake 2x2 world: the partial
  sum's ``all_reduce`` counts its output's 4·16·4 bytes as ``all-reduce``,
  its ``wait_tensor`` 0;
* the planner counts a ``wait_tensor``'s buffer once: the wait is an
  alias of its collective's output;
* capture keeps an in-place op on an intermediate nothing reads afterwards
  as its out-of-place twin (DTensor's masked lookup zeroes rows so), and
  still refuses one that a view would see.

The reference module sets ``XLA_FLAGS`` to 512 host devices when
imported; it is imported with the variable saved and restored, before
this file uses jax, so the worker keeps its one device.
"""
import math
import os
import types

import jax
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, cells_for, get_config
from repro_torch.core import TensorSpec, optimize
from repro_torch.core.scheduling.memsim import simulate_peak
from repro_torch.launch import dryrun
from repro_torch.launch.graph_analysis import COLLECTIVE_OPS, analyze_graph
from repro_torch.launch.mesh import (_mesh, destroy_world, init_fake_world,
                                     make_production_mesh)
from repro_torch.launch.sharding import ShardingRules
from repro_torch.launch.specs import input_specs

MESHES = {False: (16, 16), True: (2, 16, 16)}
MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def ref_dryrun():
    """``repro.launch.dryrun`` with ``XLA_FLAGS`` left as it was."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as m
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return m


@pytest.fixture
def world512():
    init_fake_world(512)
    yield
    destroy_world()


@pytest.fixture
def world4():
    init_fake_world(4)
    yield _mesh((2, 2), ("data", "model"), torch.device("cpu"))
    destroy_world()


SKIPPED = [(a, s) for a in ARCHS for s, spec in cells_for(get_config(a))
           if spec.get("skip")]


def test_skipped_cells_are_recorded():
    assert SKIPPED and all(s == "long_500k" for _, s in SKIPPED)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", SKIPPED)
def test_skipped_records_equal_the_references(arch, shape, multi_pod):
    ref = ref_dryrun().run_cell(arch, shape, multi_pod=multi_pod)
    assert dryrun.run_cell(arch, shape, multi_pod=multi_pod) == ref
    assert ref["status"] == "skipped"


# -- argument bytes at full width ------------------------------------------------


def _ref_rules(dims):
    from repro.launch.sharding import ShardingRules as RefRules
    names = MESH_AXES[len(dims)]
    return RefRules(types.SimpleNamespace(shape=dict(zip(names, dims)),
                                          axis_names=names))


def _ref_argument_bytes(kind, specs, dims) -> int:
    """Per-device bytes of the reference's cell arguments: each leaf's
    dims divided by the sizes of the axes its spec names."""
    rules = _ref_rules(dims)
    sizes = dict(zip(MESH_AXES[len(dims)], dims))
    if kind == "train":
        parts = [(specs["params"], rules.params_pspecs),
                 (specs["opt_state"], rules.params_pspecs),
                 (specs["batch"], rules.batch_specs)]
    elif kind == "prefill":
        parts = [(specs["params"], rules.params_pspecs),
                 (specs["batch"], rules.batch_specs)]
    else:
        parts = [(specs["params"], rules.params_pspecs),
                 (specs["state"], rules.cache_specs),
                 (specs["inp"], rules.batch_specs)]
    total = 0
    for tree, fn in parts:
        leaves = jax.tree.leaves(tree)
        pspecs = jax.tree.leaves(
            fn(tree), is_leaf=lambda x: isinstance(x, jax.sharding.
                                                   PartitionSpec))
        assert len(leaves) == len(pspecs)
        for leaf, spec in zip(leaves, pspecs):
            entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
            n = 1
            for d, e in zip(leaf.shape, entries):
                axes = () if e is None else (e if isinstance(e, tuple)
                                             else (e,))
                k = math.prod(sizes[a] for a in axes)
                assert d % k == 0
                n *= d // k
            total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_references_at_full_width(world512, arch):
    from repro.configs import get_config as ref_config
    from repro.launch.specs import input_specs as ref_input_specs
    cfg = get_config(arch)
    meshes = {mp: ShardingRules(make_production_mesh(multi_pod=mp,
                                                     device="cpu"))
              for mp in MESHES}
    seen = 0
    for shape, spec in cells_for(cfg):
        if spec.get("skip"):
            continue
        cell = input_specs(cfg, shape)
        kind, ref_specs = ref_input_specs(ref_config(arch), shape)
        for mp, dims in MESHES.items():
            got = dryrun.argument_bytes(cfg, shape, meshes[mp], cell)
            want = _ref_argument_bytes(kind, ref_specs, dims)
            assert got == want, (arch, shape, dims, got, want)
            seen += 1
    assert seen >= 6


# -- collectives in the analyzer and the planner ------------------------------


def _toy_product(mesh):
    """x (4, 8) sharded on its columns and w (8, 16) on its rows over the
    model axis: the product is a pending sum, reduced to Replicate."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def fn(x, w):
        dx = DTensor.from_local(x, mesh, [Replicate(), Shard(1)],
                                run_check=False, shape=(4, 8),
                                stride=(8, 1))
        dw = DTensor.from_local(w, mesh, [Replicate(), Shard(0)],
                                run_check=False, shape=(8, 16),
                                stride=(16, 1))
        y = dx @ dw
        return y.redistribute(placements=[Replicate(), Replicate()]
                              ).to_local()
    f32 = torch.float32
    return optimize(fn, TensorSpec((4, 4), f32), TensorSpec((4, 16), f32),
                    device="cpu", kernel_select=False)


def test_analyzer_counts_the_toy_products_all_reduce(world4):
    plan = _toy_product(world4)
    names = [n.prim_name for n in plan.plan.graph.nodes]
    assert "_c10d_functional.all_reduce.default" in names
    assert "_c10d_functional.wait_tensor.default" in names
    got = analyze_graph(plan.plan.graph, {})
    assert got["all-reduce"] == 4 * 16 * 4
    assert all(got[c] == 0 for c in COLLECTIVE_OPS if c != "all-reduce")
    assert got["collective_bytes"] == 4 * 16 * 4
    assert got["flops"] == 2 * 4 * 16 * 4


def test_the_planner_counts_a_wait_tensors_buffer_once(world4):
    plan = _toy_product(world4)
    g = plan.plan.graph
    [wait] = [n for n in g.nodes if n.prim_name ==
              "_c10d_functional.wait_tensor.default"]
    [coll] = [n for n in g.nodes if n.prim_name ==
              "_c10d_functional.all_reduce.default"]
    out = wait.outvals[0]
    assert out.base is coll.outvals[0]
    assert out.nbytes_expr.evaluate({}) == 0
    # every buffer the step makes: the product, the reduced sum, and the
    # returned copy of the wait's view, 256 bytes each; the wait adds none
    made = [v for n in g.nodes for v in n.outvals if v.base is None]
    assert sorted(v.nbytes_expr.evaluate({}) for v in made) == [256] * 3
    inputs = (4 * 4 + 4 * 16) * 4
    tl = simulate_peak(g, plan.plan.order, {})
    assert tl.peak_bytes == inputs + 2 * 256
    assert dryrun.temp_peak_bytes(g, plan.plan.order) == 2 * 256


# -- capture of an in-place op ----------------------------------------------------


def _zero_rows(x, mask):
    y = x * 2
    y[mask] = 0.0                 # index_put_ on y, read by nothing before
    return y + 1


def _zero_rows_seen_by_a_view(x, mask):
    y = x * 2
    v = y[0]
    y[mask] = 0.0
    return v + 1


def test_an_in_place_op_on_a_dead_intermediate_is_captured_out_of_place():
    f32 = torch.float32
    opt = optimize(_zero_rows, TensorSpec((5, 3), f32),
                   TensorSpec((5,), torch.bool), device="cpu")
    names = {n.prim_name for n in opt.plan.graph.nodes}
    assert "aten.index_put.default" in names
    assert "aten.index_put_.default" not in names
    x = torch.randn(5, 3)
    mask = torch.tensor([True, False, True, False, False])
    assert torch.equal(opt(x, mask), _zero_rows(x, mask))
    with pytest.raises(NotImplementedError, match="in-place op"):
        optimize(_zero_rows_seen_by_a_view, TensorSpec((5, 3), f32),
                 TensorSpec((5,), torch.bool), device="cpu")


def test_the_cli_writes_to_an_ignored_directory():
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ignored = subprocess.run(["git", "check-ignore", "-q",
                              dryrun.DEFAULT_OUT], cwd=root)
    assert ignored.returncode == 0


def test_shapes_are_the_references():
    from repro.configs.base import SHAPES as REF
    assert SHAPES == REF
