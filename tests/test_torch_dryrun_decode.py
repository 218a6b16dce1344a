"""The dry-run's decode cells keep the sequence-sharded KV cache in place.

``launch/sharding.py`` ``cache_specs`` shards a decode cache on its
widest dim the model axis divides: the 32k positions.  Under
``strategies.sharded_execution`` the cache write, the softmax over the
keys and the attention's two products then run on each rank's own rows
(``_sharded_index_copy``, ``_sharded_softmax``, ``_cache_product``).

* full size, ``llama2_1b`` and ``gemma_2b`` at ``decode_32k`` on the 16x16
  mesh of a fake 512-rank world: the reference's argument bytes, no
  collective output as large as one layer's local k shard, and all-gather
  bytes below 1/30 of what the cells gathered when DTensor moved the cache
  (34,460,925,952 and 10,063,724,544 B a device).  Their weight products
  move the few rows, not the weights (``strategies._rows_move``): the
  all-gather and the collective total below 1/3 of what they were when
  every product gathered its weight, the largest all-gather below the
  largest gathered weight then, and the FLOPs exact;
* toy steps on a fake 2x2 world, captured and read with the analyzer:
  a cache write on its sharded dim emits no all-gather and keeps its
  placements; a softmax over a sharded dim emits all-reduces of its
  ``(..., 1)`` statistics and nothing else; a one-token q with its heads on
  the model axis times a k sharded on T over the same axis moves q, never
  k.
"""
import math

import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import TensorSpec
from repro_torch.core.ir.capture import capture, tree_flatten
from repro_torch.launch import dryrun
from repro_torch.launch.graph_analysis import (COLLECTIVE_OPS, GraphAnalyzer,
                                               op_costs)
from repro_torch.launch.mesh import (_mesh, destroy_world, init_fake_world,
                                     make_production_mesh)
from repro_torch.launch.sharding import ShardingRules
from repro_torch.launch.specs import input_specs

# all-gather bytes a device when DTensor gathered the cache, and the
# cells' argument bytes (the reference's, tests/test_torch_dryrun.py)
GATHERED = {"llama2_1b": 34_460_925_952, "gemma_2b": 10_063_724_544}
ARGUMENT_BYTES = {"llama2_1b": 1_112_907_824, "gemma_2b": 383_160_424}
K_SHARD = {"llama2_1b": 134_217_728, "gemma_2b": 8_388_608}
# when every weight product gathered its weight (torch 2.13, CPU): the
# all-gather bytes a device, the collective total and the largest
# all-gather (one of llama2_1b's FFN weights, 4096 x 688 bf16), and the
# FLOPs a device, which moving the rows leaves as they were
WEIGHTS_GATHERED = {
    "llama2_1b": {"all-gather": 102_236_160, "total": 102_866_944,
                  "largest": 5_636_096},
    "gemma_2b": {"all-gather": 249_126_912, "total": 250_422_272,
                 "largest": 4_194_304}}
FLOPS = {"llama2_1b": 2_014_314_496, "gemma_2b": 4_922_015_744}


def local_cache_leaf_bytes(cfg, shape: str, rules: ShardingRules) -> int:
    """The bytes of the smallest local shard of a cache leaf that holds the
    cell's sequence (a layer's k, v, latent or RoPE key)."""
    _, specs = input_specs(cfg, shape)
    leaves, _ = tree_flatten(specs["state"])
    pspecs = dryrun._spec_leaves(rules.cache_specs(specs["state"]))
    seq = SHAPES[shape]["seq_len"]
    return min(math.prod(dryrun._local_shape(leaf.shape, rules.mesh,
                                             rules.placements(p))) *
               leaf.dtype.itemsize
               for leaf, p in zip(leaves, pspecs)
               if len(leaf.shape) >= 2 and leaf.shape[1] == seq)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["llama2_1b", "gemma_2b"])
def test_full_size_decode_keeps_the_cache_in_place(one_thread, arch):
    init_fake_world(dryrun.WORLD)
    try:
        mesh = make_production_mesh(device="cpu")
        k_shard = local_cache_leaf_bytes(get_config(arch), "decode_32k",
                                         ShardingRules(mesh))
        rec = dryrun.run_cell(arch, "decode_32k", multi_pod=False)
    finally:
        destroy_world()
    coll, largest = rec["collectives"], rec["collectives_largest"]
    print(f"{arch} decode_32k 16x16: collectives {coll}, largest "
          f"{largest}, one layer's local k shard {k_shard}, memory "
          f"{rec['memory']}")
    assert rec["status"] == "ok"
    assert k_shard == K_SHARD[arch]
    assert rec["memory"]["argument_bytes"] == ARGUMENT_BYTES[arch]
    assert max(largest.values()) < k_shard, largest
    assert coll["all-gather"] < GATHERED[arch] / 30, coll
    assert rec["memory"]["temp_bytes"] < rec["memory"]["argument_bytes"]
    before = WEIGHTS_GATHERED[arch]
    assert coll["all-gather"] < before["all-gather"] / 3, coll
    assert coll["total"] < before["total"] / 3, coll
    assert largest["all-gather"] < before["largest"], largest
    assert rec["flops"] == FLOPS[arch]


# -- toy steps on a fake 2x2 (data, model) world --------------------------------

B, T, H, HD = 4, 64, 4, 8


@pytest.fixture
def world4():
    init_fake_world(4)
    yield _mesh((2, 2), ("data", "model"), torch.device("cpu"))
    destroy_world()


def _captured(mesh, step, args):
    """``step`` on DTensors built from this rank's local shards of
    ``args`` (``(global shape, placements, dtype)`` each), captured;
    returns the graph and the placements of its DTensor outputs."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.strategies import sharded_execution
    placed = []

    def fn(*local):
        ds = [DTensor.from_local(t, mesh, p, run_check=False,
                                 shape=torch.Size(s),
                                 stride=dryrun._contiguous_stride(s))
              for t, (s, p, _) in zip(local, args)]
        with sharded_execution():
            out = step(*ds)
        placed.append(tuple(out.placements))
        return out.to_local()
    specs = [TensorSpec(dryrun._local_shape(s, mesh, p), dt)
             for s, p, dt in args]
    graph, _ = capture(fn, specs, device=torch.device("cpu"))
    return graph, placed[0]


def _collectives(graph):
    """(type, output shape, bytes) of every collective node."""
    an = GraphAnalyzer(graph, {})
    out = []
    for n in graph.nodes:
        if not n.prim_name.startswith("_c10d_functional."):
            continue
        outs = [an._value(v) for v in n.outvals]
        costs = op_costs(n.prim, an._args(n), outs)
        for c in COLLECTIVE_OPS:
            if costs[c]:
                out.append((c, outs[0].shape, int(costs[c])))
    return out


def test_a_cache_write_on_its_sharded_dim_moves_nothing(world4):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.attention import KVCache, kv_cache_update
    cache = [Shard(0), Shard(1)]            # batch on data, T on model
    f32 = torch.float32

    def step(k, k_new, length):
        return kv_cache_update(KVCache(k, k, length), k_new, k_new).k
    graph, placed = _captured(world4, step, [
        ((B, T, H, HD), cache, f32),
        ((B, 1, H, HD), [Shard(0), Replicate()], f32),
        ((), [Replicate(), Replicate()], torch.int32)])
    names = [n.prim_name for n in graph.nodes]
    assert "aten.index_copy.default" in names
    assert _collectives(graph) == []
    assert placed == tuple(cache)


def test_a_softmax_over_a_sharded_dim_reduces_its_statistics(world4):
    from torch.distributed.tensor import Shard
    placements = [Shard(0), Shard(3)]

    def step(x):
        return torch.softmax(x, dim=-1)
    graph, placed = _captured(world4, step,
                              [((B, H, 1, T), placements, torch.float32)])
    got = _collectives(graph)
    # the max and the sum, one (B/2, H, 1, 1) f32 all-reduce each
    assert got == [("all-reduce", (B // 2, H, 1, 1), B // 2 * H * 4)] * 2
    assert placed == tuple(placements)


def test_a_one_token_query_moves_and_the_cache_stays(world4):
    from torch.distributed.tensor import Shard
    f32 = torch.float32
    k_local = B // 2 * H * HD * (T // 2) * 4

    def step(q, kt):
        return torch.matmul(q, kt)
    graph, placed = _captured(world4, step, [
        ((B, H, 1, HD), [Shard(0), Shard(1)], f32),     # heads on model
        ((B, H, HD, T), [Shard(0), Shard(3)], f32)])    # T on model
    got = _collectives(graph)
    # q's heads gathered over the model axis: (B/2, H, 1, HD) of f32
    assert [(c, b) for c, _, b in got] == [("all-gather", B // 2 * H * HD * 4)]
    assert all(b < k_local for _, _, b in got)
    assert placed == (Shard(0), Shard(3))
