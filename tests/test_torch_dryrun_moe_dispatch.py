"""The MoE dispatch's scatter stays sharded on the batch (``launch/
strategies.py`` ``_scatter_rules``).

An MoE layer (``models/ffn.py`` ``moe_apply``) scatters its kept
(token, expert) pairs into a fresh zero buffer ``(B, E*C + 1, D)`` on
dim 1, and its combine scatters the slot indices on dim 1 of a
``(B, S*k)`` buffer.  torch 2.13's DTensor shards such a scatter on any
dim but the written one where the three operands agree in size; 2.11
offered only the replicated rule, so on the card's host the buffer came
out replicated and its inputs were all-gathered whole (7.1 GB a device in
the smoke ``kimi_k2_1t_a32b`` ``prefill_32k`` cell against 2.13's 0.37
GB).  The port registers 2.13's rule on both.

* the rule itself, on specs: the written dim never sharded, a dim the
  operands disagree on never sharded;
* on a fake 2x2 world, a batch-sharded index and source and a buffer in
  each placement DTensor can give it (made by ``new_zeros`` of another
  shape: replicated; given replicated or batch-sharded): the output
  sharded on the batch, no collective (nothing gathered to ``Replicate``;
  a replicated buffer is cut locally);
* the three smoke MoE cells of ``chip_smoke.py`` phase 22 (a) through
  ``run_cell`` on a fake 8-rank 2x4 world: their collective bytes a
  device on torch 2.13 byte for byte the counts before the rule, the
  train cell with ``scan_layers=False`` (the counts before its block
  remat) and with it (the recompute's repeated gathers and all-to-alls);
  on another torch their all-gather bytes within 10% of those.
"""
import dataclasses
import types

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun, strategies
from repro_torch.launch.mesh import _mesh, destroy_world, init_fake_world
from test_torch_dryrun_decode import _captured, _collectives

F32 = torch.float32
B, SK, D, SLOTS = 4, 12, 8, 17      # batch, pairs, width, E*C + 1


def _spec(*shape):
    return types.SimpleNamespace(ndim=len(shape), shape=shape)


def test_the_rule_shards_every_dim_but_the_written_one():
    from torch.distributed.tensor import Replicate, Shard
    rules = strategies._scatter_rules(_spec(B, SLOTS, D), 1,
                                      _spec(B, SK, D), _spec(B, SK, D))
    assert rules == [
        ([Replicate()], [Replicate(), None, Replicate(), Replicate()]),
        ([Shard(0)], [Shard(0), None, Shard(0), Shard(0)]),
        ([Shard(2)], [Shard(2), None, Shard(2), Shard(2)])]
    # the combine's (B, S*k) index scatter; a source of another width
    assert strategies._scatter_rules(_spec(B, SK), -1, _spec(B, SK),
                                     _spec(B, SK))[1:] == [
        ([Shard(0)], [Shard(0), None, Shard(0), Shard(0)])]
    assert strategies._scatter_rules(_spec(B, SLOTS, D), 1, _spec(B, SK, D),
                                     _spec(B, SK, 2 * D))[1:] == [
        ([Shard(0)], [Shard(0), None, Shard(0), Shard(0)])]


@pytest.fixture
def world4():
    init_fake_world(4)
    yield _mesh((2, 2), ("data", "model"), torch.device("cpu"))
    destroy_world()


BATCH_ON = [("data", ["S0", "R"]), ("both", ["S0", "S0"])]
BUFFERS = ["new_zeros", "R", "S0"]


def _placements(names):
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if n == "R" else Shard(int(n[1])) for n in names]


@pytest.mark.parametrize("buffer", BUFFERS)
@pytest.mark.parametrize("on,batch", BATCH_ON, ids=[b[0] for b in BATCH_ON])
def test_the_dispatch_scatter_stays_on_the_batch(world4, on, batch, buffer):
    from torch.distributed.tensor import Replicate, Shard
    rows = _placements(batch)
    args = [((B, SK, D), rows, torch.int64), ((B, SK, D), rows, F32)]
    if buffer != "new_zeros":
        # the buffer's mesh dims that shard the batch hold it as given
        args.append(((B, SLOTS, D), [
            p if p == Replicate() else _placements([buffer])[0]
            for p in rows], F32))

    def step(idx, src, buf=None):
        if buf is None:
            buf = src.new_zeros((B, SLOTS, D))
        return torch.scatter(buf, 1, idx.clamp(0, SLOTS - 1), src)
    graph, placed = _captured(world4, step, args)
    assert placed == tuple(rows) and placed[0] == Shard(0)
    assert _collectives(graph) == []
    assert "aten.scatter.src" in {n.prim_name for n in graph.nodes}


# -- the smoke MoE cells (phase 22 (a)) ---------------------------------------

# collective bytes a device on torch 2.13 (all-gather, all-reduce,
# reduce-scatter, all-to-all; collective-permute 0): before the rule, and
# the train cell with its block remat (its gathers and all-to-alls
# repeated in the recompute)
MOE_CELLS = {
    ("kimi_k2_1t_a32b", "prefill_32k", False):
        (369_389_568, 134_217_856, 0, 335_544_320),
    ("deepseek_v3_671b", "prefill_32k", False):
        (235_216_896, 134_217_856, 0, 335_544_320),
    ("kimi_k2_1t_a32b", "train_4k", False):
        (789_118_976, 268_594_448, 33_841_152, 838_860_800),
    ("kimi_k2_1t_a32b", "train_4k", True):
        (1_158_733_824, 268_594_704, 33_841_152, 1_174_405_120)}
TYPES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
OTHER_TORCH_TOL = 0.10


@pytest.fixture(scope="module")
def moe_cells():
    init_fake_world(8)
    get = dryrun.get_config
    out = {}
    try:
        mesh = _mesh((2, 4), ("data", "model"), torch.device("cpu"))
        for arch, shape, remat in MOE_CELLS:
            dryrun.get_config = lambda a, r=remat: dataclasses.replace(
                get_smoke_config(a), scan_layers=r)
            out[arch, shape, remat] = dryrun.run_cell(
                arch, shape, multi_pod=False, grad_accum=2, mesh=mesh)
    finally:
        dryrun.get_config = get
        destroy_world()
    return out


@pytest.mark.parametrize("cell", list(MOE_CELLS), ids=lambda c: "-".join(
    (c[0], c[1], "remat" if c[2] else "flat")))
def test_moe_cells_collectives(moe_cells, cell):
    rec = moe_cells[cell]
    assert rec["status"] == "ok"
    got = tuple(rec["collectives"][t] for t in TYPES)
    assert rec["collectives"]["collective-permute"] == 0
    if torch.__version__.startswith("2.13"):
        assert got == MOE_CELLS[cell]
    else:       # DTensor places the rest differently: all-gather held
        assert abs(got[0] - MOE_CELLS[cell][0]) <= \
            OTHER_TORCH_TOL * MOE_CELLS[cell][0], (got, cell)
