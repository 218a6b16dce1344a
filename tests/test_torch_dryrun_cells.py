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
``test_torch_dryrun_ref*.py``."""
import pytest
import torch

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import _mesh, destroy_world, init_fake_world

OTHERS = [a for a in ARCHS if a not in ("llama2_1b", "gemma_2b")]
CELLS = [(a, "decode_32k") for a in OTHERS] + \
    [(a, "prefill_32k") for a in OTHERS
     if a not in ("hymba_1p5b", "xlstm_1p3b")] + \
    [("kimi_k2_1t_a32b", "train_4k")]
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


@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_cell_runs(mesh, arch, shape):
    rec = dryrun.run_cell(arch, shape, multi_pod=False, grad_accum=2,
                          mesh=mesh)
    assert rec["status"] == "ok", rec
    assert KEYS <= set(rec)
    mem = rec["memory"]
    assert mem["total_per_device_bytes"] == mem["argument_bytes"] + \
        mem["temp_bytes"] + mem["output_bytes"]
    assert rec["flops"] > 0 and rec["collectives"]["total"] > 0
    assert set(rec["collectives"]) == {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute", "total"}
