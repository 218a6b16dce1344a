"""The kernel ops' DTensor strategies on a real multi-rank world.

On the dry-run's fake world every collective returns at once and moves
nothing, so a wrong sharding rule traces cleanly and shows only on a real
world.  Here four processes form a gloo 2x2 ``(data, model)`` world on
the CPU (``torch.multiprocessing.spawn``); each runs the smoke
``llama2_1b`` (4 heads, 4 kv heads: heads shard) and the smoke
``gemma_2b`` (1 kv head, which the model axis of 2 does not divide)
prefill and train steps as DTensors, placed by the dry-run's rules
(``launch.dryrun.shard_step``), with the kernels' plain versions.  Every
output's ``full_tensor()`` matches the one-process step to 2e-4 (f32).
"""
import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ARCHS = ["llama2_1b", "gemma_2b"]
KINDS = ["prefill", "train"]
B, S = 4, 16
TOL = 2e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _case(arch, kind, rules):
    """(max |sharded - one-process| over the outputs, output leaves)."""
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import spec_like
    from repro_torch.launch.dryrun import shard_step
    from repro_torch.launch.steps import (adamw_config_for,
                                          make_prefill_step, make_train_step)
    from repro_torch.models import init_params
    from repro_torch.optim import init_state

    cfg = get_smoke_config(arch)
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.RandomState(0)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab, (B, S))).to(torch.int32)
    if kind == "train":
        opt = init_state(params, adamw_config_for(cfg))
        batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
        args = (params, opt, batch)
        specs = {"params": spec_like(params), "opt_state": spec_like(opt),
                 "batch": spec_like(batch)}
        want = make_train_step(cfg, grad_accum=1)(*args)
    else:
        batch = {"tokens": tok}
        args = (params, batch)
        specs = {"params": spec_like(params), "batch": spec_like(batch)}
        want = make_prefill_step(cfg)(*args)
    step = shard_step(cfg, kind, specs, rules, grad_accum=1)
    got = step.dtensor_fn(*step.shard_args(*args))
    got = pytree.tree_map_only(DTensor, lambda d: d.full_tensor(), got)
    g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(g) == len(w)
    err = 0.0
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        err = max(err, (a.double() - b.double()).abs().max().item())
    return err, len(g)


def _worker(rank, world, port, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.sharding import ShardingRules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    res = {}
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for arch in ARCHS:
            for kind in KINDS:
                rules = ShardingRules(mesh)
                res[f"{arch}/{kind}"] = _case(arch, kind, rules)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo")
    mp.spawn(_worker, args=(4, _free_port(), str(out)), nprocs=4, join=True)
    return [json.load(open(out / f"rank{r}.json")) for r in range(4)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_one_process_step(results, arch, kind):
    for rank, res in enumerate(results):
        err, n = res[f"{arch}/{kind}"]
        assert n >= (1 if kind == "prefill" else 3)
        assert err <= TOL, (rank, arch, kind, err)
