"""The trainer's ``compiled`` mode and the elastic restore, against the
reference's.

* ``train(mode="compiled")``: twins of ``tests/test_system.py``'s
  ``TestTrainerCompiled`` -- one plan per batch shape, so
  ``recompilations`` is the number of distinct ``tokens.shape``s of the
  reference pipeline's batches (more than one on dynamic data, at most 4
  bucketed) -- and its losses within 1e-5 of ``mode="dynamic"``'s on the
  same batches (the f32 smoke config).
* ``Checkpointer.restore(shardings=)``: onto a (1,1) mesh of a gloo
  world, every leaf a DTensor whose local tensor is the saved one,
  bitwise; on a fake 2x2 world, rank 0's local shards are the slices its
  placements give; a DTensor state saves its full logical tensors.
* ``examples/torch_elastic_restart.py`` on the CPU: the kill, the restore,
  the bitwise resume and the restore onto a 1x1 mesh.

Every test that starts a process group destroys it in a fixture.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core import spec_like
from repro_torch.launch.mesh import (destroy_world, init_fake_world,
                                     make_debug_mesh)
from repro_torch.launch.sharding import ShardingRules
from repro_torch.launch.train import train
from repro_torch.models import init_params
from repro_torch.optim import init_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_smoke_config("llama2-1b")
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def world():
    """Tears down whatever process group the test starts."""
    destroy_world()
    yield
    destroy_world()


def _ref_shapes(data_mode, steps, batch_size=4):
    """The distinct ``tokens`` shapes of the reference pipeline's first
    ``steps`` batches, as the reference trainer draws them."""
    from repro.data import DataPipeline, PipelineConfig
    pipe = DataPipeline(PipelineConfig(vocab=CFG.vocab, batch_size=batch_size,
                                       seed=0, mode=data_mode, min_tokens=16,
                                       max_tokens=96))
    return {pipe.next_batch()["tokens"].shape for _ in range(steps)}


# -- train(mode="compiled") ------------------------------------------------------


def test_compiled_path_recompiles_per_shape():
    stats = train(CFG, steps=8, batch_size=4, mode="compiled",
                  data_mode="dynamic", log_every=100, device="cpu")
    shapes = _ref_shapes("dynamic", 8)
    assert stats["recompilations"] == len(shapes) > 1
    assert set(stats["steps_by_shape"].plans) == shapes
    assert all(np.isfinite(stats["losses"]))


def test_bucketed_limits_recompiles_with_the_dynamic_losses():
    compiled = train(CFG, steps=8, batch_size=4, mode="compiled",
                     data_mode="bucketed", log_every=100, device="cpu")
    shapes = _ref_shapes("bucketed", 8)
    assert compiled["recompilations"] == len(shapes) <= 4
    steps = compiled["steps_by_shape"]
    assert set(steps.plans) == set(steps.compile_s) == shapes
    for key, fn in steps.plans.items():
        assert fn.last_report.stats.device_peak <= \
            steps.guaranteed_peak_bytes[key]
    dynamic = train(CFG, steps=8, batch_size=4, mode="dynamic",
                    data_mode="bucketed", log_every=100, device="cpu")
    assert dynamic["recompilations"] == 0
    np.testing.assert_allclose(compiled["losses"], dynamic["losses"],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    assert compiled["tokens"] == dynamic["tokens"]


def test_compiled_mode_ignores_the_memory_limit():
    """As the reference's jit path does: the limit changes nothing."""
    free = train(CFG, steps=1, batch_size=4, mode="compiled",
                 data_mode="bucketed", log_every=100, device="cpu")
    capped = train(CFG, steps=1, batch_size=4, mode="compiled",
                   data_mode="bucketed", memory_limit=1, log_every=100,
                   device="cpu")
    assert capped["losses"] == free["losses"]
    with pytest.raises(ValueError, match="mode"):
        train(CFG, steps=1, mode="jit", device="cpu")


# -- elastic restore -------------------------------------------------------------


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The smoke llama2_1b's weights and AdamW state (a step of nonzero
    moments), checkpointed."""
    params = init_params(CFG, 0, device="cpu")
    opt = init_state(params)
    opt = opt._replace(step=opt.step + 3, m=pytree.tree_map(
        lambda p: p * 0.5, params), v=pytree.tree_map(lambda p: p * p,
                                                       params))
    state = {"params": params, "opt_state": opt}
    d = str(tmp_path_factory.mktemp("ck"))
    Checkpointer(d).save(7, state, extra={"cursor": 7})
    return d, state


def _shardings(rules, state):
    return {"params": rules.named(rules.params_pspecs(
                spec_like(state["params"]))),
            "opt_state": rules.named(rules.params_pspecs(
                spec_like(state["opt_state"])))}


def test_restore_onto_a_1x1_gloo_mesh_is_bitwise(world, saved):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    d, state = saved
    rules = ShardingRules(make_debug_mesh(1, 1, device="cpu"))
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    step, got, extra = Checkpointer(d).restore(
        device="cpu", shardings=_shardings(rules, state))
    assert (step, extra) == (7, {"cursor": 7})
    want, got = pytree.tree_leaves(state), pytree.tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, DTensor)
        assert g.to_local().dtype == w.dtype
        assert torch.equal(g.to_local(), w)
        assert torch.equal(g.full_tensor(), w)


def _rank0_slice(x, placements, sizes):
    """Rank 0's shard: for each mesh dim in order, the first of its
    ``torch.chunk``s along the sharded tensor dim."""
    from torch.distributed.tensor import Shard
    for p, n in zip(placements, sizes):
        if isinstance(p, Shard):
            x = x.chunk(n, dim=p.dim)[0]
    return x


def test_restore_onto_a_fake_2x2_world_cuts_rank0s_shards(world, saved):
    d, state = saved
    init_fake_world(4)
    mesh = make_debug_mesh(2, 2, device="cpu")
    rules = ShardingRules(mesh)
    shardings = _shardings(rules, state)
    _, got, _ = Checkpointer(d).restore(device="cpu", shardings=shardings)
    named = pytree.tree_leaves(shardings,
                               is_leaf=lambda x: hasattr(x, "placements"))
    n_sharded = 0
    for g, w, ns in zip(pytree.tree_leaves(got), pytree.tree_leaves(state),
                        named):
        want = _rank0_slice(w, ns.placements, mesh.shape)
        assert torch.equal(g.to_local(), want)
        assert tuple(g.shape) == tuple(w.shape)
        n_sharded += want.numel() < w.numel()
    # the 2-way axes divide the smoke widths: most matrices are cut
    assert n_sharded >= 2 * CFG.n_layers * 7


def test_a_dtensor_state_saves_its_full_tensors(world, saved, tmp_path):
    d, state = saved
    rules = ShardingRules(make_debug_mesh(1, 1, device="cpu"))
    _, got, _ = Checkpointer(d).restore(
        device="cpu", shardings=_shardings(rules, state))
    ck = Checkpointer(str(tmp_path))
    ck.save(8, got)
    _, back, _ = ck.restore(device="cpu")
    assert all(type(b) is torch.Tensor and torch.equal(b, w)
               for b, w in zip(pytree.tree_leaves(back),
                               pytree.tree_leaves(state)))


def test_elastic_example_is_bitwise_on_the_cpu(world, capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_elastic_restart",
        os.path.join(ROOT, "examples", "torch_elastic_restart.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert out == {"restored_at": 9, "replayed": 4}
    assert "crash: worker lost before request 7" in text
    assert "match the uninterrupted run bitwise: True" in text
    assert "1-device mesh OK (gloo)" in text
    import torch.distributed as dist
    assert not dist.is_initialized()    # the example destroys its world
