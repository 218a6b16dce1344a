"""The dry-run's products with a sharded weight move whichever side is
smaller, as XLA's partitioner does (``launch/strategies.py``
``_product_plans``, ``_rows_move``).

For ``x @ w`` with a weight sharded on a mesh dim that also shards the
rows of ``x``, (W) gathers the weight there (FSDP's way) and (R) moves
the rows: ``x`` onto the weight's contraction shard (an all-to-all), the
local product a pending sum, all-reduced, the rows cut back.  The cost
rule takes the one that moves fewer bytes, (W) on a tie, on a symbolic
size and wherever an operand requires a gradient.  An MoE layer's expert
products (a 3-D weight sharded on its expert dim) run on each rank's own
experts: the activations go to the expert shard in one all-to-all, and
the product that ends the block sends its output back in another.

Toy steps on a fake 4-rank 2x2 ``(data, model)`` world, captured and
read with the analyzer (``test_torch_dryrun_decode._captured``,
``_collectives``).
"""
import types

import pytest
import torch

from repro_torch.launch import strategies
from repro_torch.launch.graph_analysis import GraphAnalyzer
from repro_torch.launch.mesh import _mesh, destroy_world, init_fake_world
from test_torch_dryrun_decode import _captured, _collectives

F32 = torch.float32


@pytest.fixture
def world4():
    init_fake_world(4)
    yield _mesh((2, 2), ("data", "model"), torch.device("cpu"))
    destroy_world()


def _product(mesh, xs, xp, ws, wp, grad=False):
    """``x @ w`` at the given global shapes and placements, captured:
    (collectives as ``(type, bytes)``, the output's placements)."""
    def step(x, w):
        if grad:
            w = w.detach().requires_grad_()
        return x @ w
    graph, placed = _captured(mesh, step, [(xs, xp, F32), (ws, wp, F32)])
    return [(c, b) for c, _, b in _collectives(graph)], placed


def test_a_decode_product_moves_the_rows(world4):
    from torch.distributed.tensor import Replicate, Shard
    # 8 rows against a 256 x 1024 weight, contraction sharded on data
    got, placed = _product(world4, (8, 1, 256), [Shard(0), Replicate()],
                           (256, 1024), [Shard(0), Shard(1)])
    gathered_w = 256 * 512 * 4          # the weight gathered on data
    # the rows onto the contraction shard (8 x 128), the (8, 512) output
    # share all-reduced; nothing gathered
    assert got == [("all-to-all", 8 * 128 * 4), ("all-reduce", 8 * 512 * 4)]
    assert all(b < gathered_w for _, b in got)
    assert placed == (Shard(0), Shard(2))


def test_an_output_sharded_product_moves_the_rows_back(world4):
    from torch.distributed.tensor import Partial, Shard
    # wo / w2: the weight's output dim on data, the contraction on model
    got, placed = _product(world4, (8, 1, 256), [Shard(0), Shard(2)],
                           (256, 1024), [Shard(1), Shard(0)])
    # the rows gathered on data (8 x 128), the (8, 512) output's columns
    # back onto its rows in one all-to-all; the model axis's pending sum
    # stays, as (W) leaves it
    assert got == [("all-gather", 8 * 128 * 4), ("all-to-all", 4 * 1024 * 4)]
    assert placed == (Shard(0), Partial())


@pytest.mark.parametrize("case", ["rows", "grad"])
def test_a_train_product_gathers_the_weight(world4, case):
    from torch.distributed.tensor import Replicate, Shard
    # many rows (a micro-batch), or a weight that requires a gradient
    rows = (8, 512, 256) if case == "rows" else (8, 1, 256)
    got, placed = _product(world4, rows, [Shard(0), Replicate()],
                           (256, 1024), [Shard(0), Shard(1)],
                           grad=case == "grad")
    assert got == [("all-gather", 256 * 512 * 4)]     # today's plan
    assert placed == (Shard(0), Shard(2))


def test_a_tie_keeps_the_weight_gather(world4):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    # K = N = 2 B: the gathered weight (16 x 8) and the rows' shard
    # (8 x 8) plus the output share (8 x 8) are 512 bytes each
    xp, wp = [Shard(0), Replicate()], [Shard(0), Shard(1)]
    x = DTensor.from_local(torch.zeros(4, 1, 16), world4, xp,
                           run_check=False, shape=torch.Size((8, 1, 16)),
                           stride=(16, 16, 1))
    w = DTensor.from_local(torch.zeros(8, 8), world4, wp, run_check=False,
                           shape=torch.Size((16, 16)), stride=(16, 1))
    _, r_plan, cost_w, cost_r = strategies._product_plans(
        x, w, "aby", "yz", "abz")
    assert r_plan is not None and cost_w == cost_r == 512
    assert strategies._rows_move(x, w, "aby", "yz", "abz")[1] is None
    got, _ = _product(world4, (8, 1, 16), xp, (16, 16), wp)
    assert got == [("all-gather", 512)]


def test_a_symbolic_size_keeps_the_weight_gather(world4):
    from torch.distributed.tensor import Replicate, Shard
    from torch.fx.experimental.symbolic_shapes import ShapeEnv
    rows = ShapeEnv().create_unbacked_symint()
    x = types.SimpleNamespace(shape=(rows, 1, 256), dtype=F32,
                              device_mesh=world4,
                              placements=(Shard(0), Replicate()))
    w = types.SimpleNamespace(shape=(256, 1024), dtype=F32,
                              device_mesh=world4,
                              placements=(Shard(0), Shard(1)))
    w_plan, r_plan, cost_w, cost_r = strategies._product_plans(
        x, w, "aby", "yz", "abz")
    assert r_plan is not None and cost_w is None and cost_r is None
    assert strategies._rows_move(x, w, "aby", "yz", "abz") == (w_plan, None)


def test_expert_products_run_on_the_local_experts(world4):
    from torch.distributed.tensor import Shard
    e, c, d, f = 8, 16, 64, 32
    buf = [Shard(0), Shard(0)]           # the batch on both mesh dims
    # the MoE rules: (E, D, F) on model x data, (E, F, D) likewise
    w13, w2 = [Shard(1), Shard(0)], [Shard(2), Shard(0)]

    def step(x, wa, wb):
        h = torch.einsum("becd,edf->becf", x, wa)
        return torch.einsum("becf,efd->becd", h, wb)
    graph, placed = _captured(world4, step, [
        ((4, e, c, d), buf, F32), ((e, d, f), w13, F32),
        ((e, f, d), w2, F32)])
    got = _collectives(graph)
    local = 1 * e * c * d * 4           # one rank's (1, E, C, D) rows
    # the dispatch onto the expert shard and the combine back, one
    # all-to-all each, and each weight's D gathered on data
    assert [(k, b) for k, _, b in got] == [
        ("all-to-all", local), ("all-gather", e // 2 * d * f * 4),
        ("all-gather", e // 2 * f * d * 4), ("all-to-all", local)]
    # both products are batched over this rank's 4 experts, of 2 examples
    an = GraphAnalyzer(graph, {})
    bmm = [[an._value(v).shape for v in n.invals[:2]] for n in graph.nodes
           if n.prim_name == "aten.bmm.default"]
    assert bmm == [[(e // 2, 2 * c, d), (e // 2, d, f)],
                   [(e // 2, 2 * c, f), (e // 2, f, d)]]
    assert placed == tuple(buf)
