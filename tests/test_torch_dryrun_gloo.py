"""The kernel ops' DTensor strategies on a real multi-rank world.

On the dry-run's fake world every collective returns at once and moves
nothing, so a wrong sharding rule traces cleanly and shows only on a real
world.  Here four processes form a gloo 2x2 ``(data, model)`` world on
the CPU (``torch.multiprocessing.spawn``); each runs the smoke
``llama2_1b`` (4 heads, 4 kv heads: heads shard) and the smoke
``gemma_2b`` (1 kv head, which the model axis of 2 does not divide)
prefill, train and decode steps as DTensors, placed by the dry-run's
rules (``launch.dryrun.shard_step``), with the kernels' plain versions.
Every output's ``full_tensor()`` matches the one-process step to 2e-4
(f32).

The decode cache has ``T`` rows, its widest dim, so the rules shard it on
T over the model axis (``strategies`` writes it and attends to it in
place).  The step runs at four cache lengths, so the new row lands inside
model rank 0's slice, on its last row, on model rank 1's first row and on
the last row of all; the written cache must equal the one-process write
bit for bit (a write is a copy) and keep its placements.

A product with a sharded weight whose rows are few takes the (R) plan
(``strategies._rows_move``: the rows move, not the weight); three such
products (the contraction, the output dim, the columns on the model
axis) match the one-process product.  A smoke ``kimi_k2_1t_a32b`` MoE
layer (``models.ffn.moe_apply``), its weights placed by the dry-run's
rules and its input's batch sharded on the model axis or replicated
there, matches the one-process layer, output and every gradient, with
each expert product on its rank's own experts.  Which plan its products
take follows the placements DTensor gives the dispatch buffer, which
differ between torch versions; so a pair of expert products on a buffer
placed here is held too, at one slot an expert (the rows move, with
their own backward) and at 64 (the weights are gathered).  A pending
sum changes the order of the adds, hence 2e-4 (f32).
"""
import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ARCHS = ["llama2_1b", "gemma_2b"]
KINDS = ["prefill", "train", "decode"]
B, S = 4, 16
TOL = 2e-4
T = 64                    # decode cache rows: 32 a model rank
LENGTHS = [5, 31, 32, 63]
# decode batches: B shards on data; at 1 the data axis replicates the
# cache, and the products split its rows over data as well
DECODE_BATCHES = [B, 1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _decode_args(cfg, params, rng, length, batch):
    """A decode step's arguments: ``batch`` caches of ``T`` rows drawn from
    ``rng`` holding ``length`` valid rows, and one token a row."""
    from repro_torch.core.ir.capture import tree_flatten, tree_unflatten
    from repro_torch.models import init_cache

    def fill(t):
        if t.dtype == torch.int32:
            return torch.tensor(length, dtype=torch.int32)
        return torch.from_numpy(rng.standard_normal(tuple(t.shape))).to(
            t.dtype)
    leaves, tdef = tree_flatten(init_cache(cfg, batch, T, device="cpu"))
    state = tree_unflatten([fill(t) for t in leaves], tdef)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab, (batch, 1))).to(
        torch.int32)
    return params, state, {"token": tok}


def _write_bitwise(rules, rng, length) -> bool:
    """``kv_cache_update`` on DTensors, the cache sharded on T over the
    model axis and the new rows on their heads, equals the one-process
    write bit for bit."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.strategies import sharded_execution
    from repro_torch.models.attention import KVCache, kv_cache_update

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).float()
    k, v, kn, vn = rand(B, T, 4, 8), rand(B, T, 4, 8), rand(B, 1, 4, 8), \
        rand(B, 1, 4, 8)
    n = torch.tensor(length, dtype=torch.int32)
    want = kv_cache_update(KVCache(k, v, n), kn, vn)
    mesh = rules.mesh

    def put(t, *p):
        return distribute_tensor(t, mesh, list(p), src_data_rank=None)
    with sharded_execution():
        got = kv_cache_update(
            KVCache(put(k, Shard(0), Shard(1)), put(v, Shard(0), Shard(1)),
                    put(n, Replicate(), Replicate())),
            put(kn, Shard(0), Shard(2)), put(vn, Shard(0), Shard(2)))
    return all(torch.equal(a.full_tensor(), b) for a, b in zip(got, want))


def _case(arch, kind, rules, length=None, batch=B):
    """(max |sharded - one-process| over the outputs, output leaves); for
    decode also whether the written cache is bitwise the one-process one
    and whether its leaves came back on the placements they went in at,
    sharded on T."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import spec_like
    from repro_torch.core.ir.capture import tree_flatten
    from repro_torch.launch.dryrun import shard_step
    from repro_torch.launch.steps import (adamw_config_for,
                                          make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models import init_params
    from repro_torch.optim import init_state

    cfg = get_smoke_config(arch)
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.RandomState(0)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab, (B, S))).to(torch.int32)
    if kind == "decode":
        args = _decode_args(cfg, params, rng, length, batch)
        specs = {"params": spec_like(args[0]), "state": spec_like(args[1]),
                 "inp": spec_like(args[2])}
        want = make_serve_step(cfg)(*args)
        step = shard_step(cfg, kind, specs, rules)
        got = step.dtensor_fn(*step.shard_args(*args))
        model = rules.mesh.mesh_dim_names.index("model")
        caches = [d for d in tree_flatten(got[1])[0] if d.ndim == 4]
        placed = len(caches) == 2 * cfg.n_layers and all(
            d.placements[model] == Shard(1) for d in caches)
        full = pytree.tree_map_only(DTensor, lambda d: d.full_tensor(), got)
        g, w = tree_flatten(full[1])[0], tree_flatten(want[1])[0]
        assert len(g) == len(w) and full[0].shape == want[0].shape
        # a layer's new row is its k or v of the token, which the sharded
        # step computes from sums over the cache's shards: equal to
        # rounding past the first layer; every other row is a copy
        rest = [(a[:, torch.arange(T) != length], b[:, torch.arange(T) !=
                                                   length])
                if a.ndim == 4 else (a, b) for a, b in zip(g, w)]
        bitwise = all(torch.equal(a, b) for a, b in rest) and \
            _write_bitwise(rules, rng, length)
        err = max((a.double() - b.double()).abs().max().item()
                  for a, b in [(full[0], want[0])] + list(zip(g, w)))
        return err, len(g) + 1, bitwise, placed
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


# (name, x's shape and placements, w's): each takes the (R) plan
PRODUCTS = [("contraction", (4, 1, 64), ("S0", "R"), (64, 256), ("S0", "S1")),
            ("output", (4, 1, 256), ("S0", "S2"), (256, 64), ("S1", "S0")),
            ("columns", (4, 1, 64), ("S0", "S0"), (64, 512), ("R", "S1"))]
# an MoE layer's input: its batch on data, and on model or not; a
# prefill-like 256 tokens a row or a decode-like 1
MOE_CASES = [(p, s) for p in ("S0", "R") for s in (256, 1)]
# expert slots for the pair of expert products, and whether their rows
# move: (R) at 1, (W) at 64
EXPERT_SLOTS = {1: True, 64: False}


def _placements(names):
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if n == "R" else Shard(int(n[1:])) for n in names]


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape)).float()


def _product_case(mesh, rng, xs, xp, ws, wp):
    """(whether ``x @ w`` took the (R) plan, max |sharded - one-process|)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import strategies
    x, w = _rand(rng, *xs), _rand(rng, *ws)
    dx = distribute_tensor(x, mesh, _placements(xp), src_data_rank=None)
    dw = distribute_tensor(w, mesh, _placements(wp), src_data_rank=None)
    rows = "abcdefgh"[:x.ndim - 1]
    took = strategies._rows_move(dx, dw, rows + "y", "yz",
                                 rows + "z")[1] is not None
    with strategies.sharded_execution():
        got = dx @ dw
    return took, (got.full_tensor() - x @ w).abs().max().item()


def _seen_plans(fn, *args):
    """``fn(*args)`` and the plans of the expert products it ran."""
    from repro_torch.launch import strategies
    plans = []
    real = strategies._ExpertProduct.apply

    def seen(plan, *rest):
        plans.append(plan)
        return real(plan, *rest)
    strategies._ExpertProduct.apply = seen
    try:
        return fn(*args), plans
    finally:
        strategies._ExpertProduct.apply = real


def _expert_pair(mesh, rng, slots):
    """``einsum(einsum(x, w1), w2)``'s loss and gradients on DTensors (the
    batch of the (4, 8, slots, 64) buffer on both mesh dims, the weights
    on the MoE rules' placements) against one process: (max error, the
    plans took (R))."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import strategies
    # the weights scaled by their fan-in, as ``moe_init`` draws them
    xs, dy = _rand(rng, B, 8, slots, 64), _rand(rng, B, 8, slots, 64)
    w1, w2 = _rand(rng, 8, 64, 32) / 8, _rand(rng, 8, 32, 64) / 32 ** 0.5

    def loss(x, a, b, y):
        h = torch.einsum("becd,edf->becf", x, a)
        return (torch.einsum("becf,efd->becd", h, b) * y).sum()
    ts = [t.clone().requires_grad_() for t in (xs, w1, w2)]
    want = torch.autograd.grad(loss(*ts, dy), ts)
    ds = [distribute_tensor(t, mesh, _placements(p), src_data_rank=None)
          .requires_grad_() for t, p in zip(
              (xs, w1, w2), (("S0", "S0"), ("S1", "S0"), ("S2", "S0")))]

    def run():
        with strategies.sharded_execution():
            return torch.autograd.grad(loss(*ds, distribute_tensor(
                dy, mesh, _placements(("S0", "S0")), src_data_rank=None)),
                ds)
    got, plans = _seen_plans(run)
    assert len(plans) == 2
    err = max((g.full_tensor() - w).abs().max().item()
              for g, w in zip(got, want))
    # (W) keeps the batch on data; (R) moves it
    return err, all(p.x[0] != _placements(["S0"])[0] for p in plans)


def _moe_case(rules, rng, model_placement, tokens):
    """A smoke MoE layer's loss ``sum(out * dy) + aux`` on DTensors against
    one process: the max error of the loss and of every gradient."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import strategies
    from repro_torch.models.ffn import moe_apply, moe_init
    cfg = get_smoke_config("kimi_k2_1t_a32b")
    params = moe_init(torch.Generator().manual_seed(0), cfg.d_model,
                      cfg.d_ff, cfg.n_experts, cfg.n_shared, torch.float32)
    x, dy = (_rand(rng, B, tokens, cfg.d_model) for _ in range(2))

    def loss(p, xx, yy):
        out, aux = moe_apply(p, xx, top_k=cfg.top_k, ffn_kind=cfg.ffn_kind)
        return (out * yy).sum() + aux
    flat, tdef = pytree.tree_flatten_with_path(params)
    leaves = [t.clone().requires_grad_() for _, t in flat]
    xr = x.clone().requires_grad_()
    want = loss(pytree.tree_unflatten(leaves, tdef), xr, dy)
    wgrads = torch.autograd.grad(want, leaves + [xr])

    mesh = rules.mesh
    xp = [Shard(0), _placements([model_placement])[0]]
    dleaves = [distribute_tensor(t, mesh, rules.placements(rules.spec_for(
        "moe/" + "/".join(str(k.key) for k in path), tuple(t.shape))),
        src_data_rank=None).requires_grad_() for path, t in flat]
    dx = distribute_tensor(x, mesh, xp, src_data_rank=None).requires_grad_()
    def run():
        with strategies.sharded_execution():
            got = loss(pytree.tree_unflatten(dleaves, tdef), dx,
                       distribute_tensor(dy, mesh, xp, src_data_rank=None))
            return got, torch.autograd.grad(got, dleaves + [dx])
    (got, grads), plans = _seen_plans(run)
    # w1, w3 and w2, each on this rank's own experts
    assert len(plans) == 3 and all(
        p.x[rules.mesh.mesh_dim_names.index("model")] == Shard(1)
        for p in plans), plans
    return max([(got.full_tensor() - want).abs().item()] +
               [(g.full_tensor() - w).abs().max().item()
                for g, w in zip(grads, wgrads)])


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
            for kind in KINDS[:2]:
                rules = ShardingRules(mesh)
                res[f"{arch}/{kind}"] = _case(arch, kind, rules)
            runs = [f"{arch}/decode/{b}/{n}" for b in DECODE_BATCHES
                    for n in LENGTHS]
            for b in DECODE_BATCHES:
                for n in LENGTHS:
                    res[f"{arch}/decode/{b}/{n}"] = _case(
                        arch, "decode", ShardingRules(mesh), n, b)
            res[f"{arch}/decode"] = (max(res[r][0] for r in runs),
                                     min(res[r][1] for r in runs))
        rng = np.random.RandomState(1)
        for name, *shapes in PRODUCTS:
            res[f"product/{name}"] = _product_case(mesh, rng, *shapes)
        for p, tokens in MOE_CASES:
            res[f"moe/{p}/{tokens}"] = _moe_case(ShardingRules(mesh), rng, p,
                                                 tokens)
        for slots in EXPERT_SLOTS:
            res[f"experts/{slots}"] = _expert_pair(mesh, rng, slots)
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


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("batch", DECODE_BATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_writes_the_cache_in_place(results, arch, batch,
                                                 length):
    for rank, res in enumerate(results):
        err, n, bitwise, placed = res[f"{arch}/decode/{batch}/{length}"]
        assert placed, (rank, arch, batch, length, "cache not on T")
        assert bitwise, (rank, arch, batch, length, "the write is no copy")
        assert err <= TOL, (rank, arch, batch, length, err)


@pytest.mark.parametrize("name", [p[0] for p in PRODUCTS])
def test_a_rows_moved_product_matches_the_one_process_product(results, name):
    for rank, res in enumerate(results):
        took, err = res[f"product/{name}"]
        assert took, (rank, name, "the rule kept the weight gather")
        assert err <= TOL, (rank, name, err)


@pytest.mark.parametrize("placement,tokens", MOE_CASES)
def test_sharded_moe_layer_matches_the_one_process_layer(results, placement,
                                                        tokens):
    for rank, res in enumerate(results):
        err = res[f"moe/{placement}/{tokens}"]
        assert err <= TOL, (rank, placement, tokens, err)


@pytest.mark.parametrize("slots", list(EXPERT_SLOTS))
def test_expert_products_match_the_one_process_products(results, slots):
    for rank, res in enumerate(results):
        err, rows_moved = res[f"experts/{slots}"]
        assert rows_moved == EXPERT_SLOTS[slots], (rank, slots)
        assert err <= TOL, (rank, slots, err)
