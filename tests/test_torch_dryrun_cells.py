"""Every family's cells through the dry-run, at smoke width on a fake
8-rank world (a 2x4 ``(data, model)`` mesh), at the cells' own batch and
sequence: each record ``ok`` with the reference's keys, a positive FLOP
count and collective bytes (the step runs sharded).  These reach the
DTensor rules ``launch.strategies`` adds beside the kernel ops' (the KV
cache write, MoE routing's ``searchsorted``, the xLSTM gates'
``log_sigmoid``) and the MoE aux loss's expert counts.  Not run here:
the prefill of the smoke hymba and xlstm configs (a 32k sequence in
their smoke blocks and chunks is tens of thousands of nodes) and their
train cells; ``llama2_1b`` and ``gemma_2b`` are in
``test_torch_dryrun_ref*.py``.

Every decode cell whose cache holds the sequence (all but xLSTM's, whose
state has none) keeps that cache where ``cache_specs`` shards it: no
collective output is as large as one layer's local cache leaf (the
smallest local shard of a leaf that holds the sequence).  That covers
hymba's ``long_500k`` too, at B = 1 with the sequence sharded on ``data``.

The MoE cells run their expert products on each rank's own experts
(``strategies._expert_product``): no all-gather in their graphs
collects an expert weight's experts on the model axis.  The dense
families' prefill cells, whose products all gather their weights (their
rows outweigh the weights), keep the FLOPs, argument bytes and
collectives they had before the products could move the rows instead
(``DENSE``, recorded then); their train cells are held so in
``test_torch_dryrun_ref.py``, which runs them already."""
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.graph_analysis import GraphAnalyzer
from repro_torch.launch.mesh import _mesh, destroy_world, init_fake_world
from repro_torch.launch.sharding import ShardingRules
from test_torch_dryrun_decode import local_cache_leaf_bytes

OTHERS = [a for a in ARCHS if a not in ("llama2_1b", "gemma_2b")]
CELLS = [(a, "decode_32k") for a in OTHERS] + \
    [("hymba_1p5b", "long_500k")] + \
    [(a, "prefill_32k") for a in OTHERS
     if a not in ("hymba_1p5b", "xlstm_1p3b")] + \
    [("kimi_k2_1t_a32b", "train_4k")]
SEQUENCE_CACHES = [(a, s) for a, s in CELLS
                   if SHAPES[s]["kind"] == "decode" and
                   get_smoke_config(a).block_kind != "xlstm"]
MOE_CELLS = [(a, s) for a, s in CELLS if get_smoke_config(a).n_experts]
# (FLOPs, argument bytes, collectives: all-gather, all-reduce,
# reduce-scatter, all-to-all, collective-permute) of the smoke prefill
# cells on the 2x4 mesh, before a product could move its rows (torch 2.13)
DENSE = {
    ("llama2_1b", "prefill_32k"): (9_020_505_063_424, 2_628_096, (
        4_677_632, 268_435_456, 134_217_728, 0, 0)),
    ("gemma_2b", "prefill_32k"): (4_425_963_798_528, 2_159_872, (
        403_197_952, 134_217_728, 0, 0, 0))}
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
RECORDS = {}      # (arch, shape) -> record, run once for both tests
GATHERS = {}      # (arch, shape) -> the output shapes of its all-gathers
KEYS = {"arch", "shape", "mesh", "params", "params_active", "grad_accum",
        "lower_s", "compile_s", "memory", "cost", "flops", "bytes_accessed",
        "collectives", "scaled", "scaled_warnings", "hlo_bytes",
        "sharding_fallbacks", "status"}


@pytest.fixture(scope="module")
def mesh():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    init_fake_world(8)
    get = dryrun.get_config
    dryrun.get_config = get_smoke_config
    yield _mesh((2, 4), ("data", "model"), torch.device("cpu"))
    dryrun.get_config = get
    destroy_world()
    torch.set_num_threads(n)


def _record(mesh, arch, shape):
    if (arch, shape) not in RECORDS:
        plans = []
        real = dryrun.plan_step

        def kept(sharded, **kwargs):
            plans.append(real(sharded, **kwargs))
            return plans[-1]
        dryrun.plan_step = kept
        try:
            RECORDS[arch, shape] = dryrun.run_cell(
                arch, shape, multi_pod=False, grad_accum=2, mesh=mesh)
        finally:
            dryrun.plan_step = real
        if (arch, shape) in MOE_CELLS:
            graph = plans[0].plan.graph
            an = GraphAnalyzer(graph, {})
            GATHERS[arch, shape] = [
                an._value(n.outvals[0]).shape for n in graph.nodes
                if n.prim_name.startswith("_c10d_functional.all_gather")]
    return RECORDS[arch, shape]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_cell_runs(mesh, arch, shape):
    rec = _record(mesh, arch, shape)
    assert rec["status"] == "ok", rec
    assert KEYS <= set(rec)
    mem = rec["memory"]
    assert mem["total_per_device_bytes"] == mem["argument_bytes"] + \
        mem["temp_bytes"] + mem["output_bytes"]
    assert rec["flops"] > 0 and rec["collectives"]["total"] > 0
    assert set(rec["collectives"]) == {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute", "total"}


@pytest.mark.parametrize("arch,shape", SEQUENCE_CACHES)
def test_smoke_decode_cell_keeps_the_cache_in_place(mesh, arch, shape):
    rec = _record(mesh, arch, shape)
    leaf = local_cache_leaf_bytes(get_smoke_config(arch), shape,
                                  ShardingRules(mesh))
    print(f"{arch} {shape}: collectives {rec['collectives']}, largest "
          f"{rec['collectives_largest']}, a layer's local cache leaf {leaf}")
    assert rec["status"] == "ok", rec
    assert max(rec["collectives_largest"].values()) < leaf, \
        (rec["collectives_largest"], leaf)


@pytest.mark.parametrize("arch,shape", MOE_CELLS)
def test_smoke_moe_cell_keeps_the_experts_sharded(mesh, arch, shape):
    cfg = get_smoke_config(arch)
    _record(mesh, arch, shape)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    # an expert weight (E, D, F) or (E, F, D), D whole or on data, with
    # all E experts on one rank
    whole = {(e, a, b) for a, b in ((d, f), (d // 2, f), (f, d), (f, d // 2))}
    got = [s for s in GATHERS[arch, shape] if tuple(s) in whole]
    print(f"{arch} {shape}: {len(GATHERS[arch, shape])} all-gathers, "
          f"collectives {RECORDS[arch, shape]['collectives']}")
    assert got == [], got


@pytest.mark.parametrize("arch,shape", list(DENSE))
def test_smoke_dense_prefill_records_are_unchanged(mesh, arch, shape):
    rec = _record(mesh, arch, shape)
    flops, args, coll = DENSE[arch, shape]
    assert rec["status"] == "ok", rec
    assert rec["flops"] == flops
    assert rec["memory"]["argument_bytes"] == args
    assert tuple(rec["collectives"][c] for c in COLLECTIVES) == coll, \
        rec["collectives"]
