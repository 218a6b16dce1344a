"""At smoke size, the dry-run's decode cells split their work over the
ranks: a cell on the tests' 2x4 ``(data, model)`` fake world counts the
FLOPs of its one-rank step split 8 ways, to within REPEAT_TOL, so no rank
repeats another's product.

The cells are those where ``strategies._cache_product`` does more than
keep the sequence-sharded cache in place: MLA's latent cache
(``deepseek_v3_671b``), whose pending sum goes back onto the heads
before ``W_UV``; hymba's ``long_500k`` at B = 1, where the data axis
replicates the cache and the products split its rows over it; and
``gemma_2b``'s one kv head, which the model axis does not divide.
"""
import math

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import _mesh, destroy_world, init_fake_world


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# FLOPs a device x 8 over the one-rank step's; hymba's B = 1 SSM products,
# which no mesh axis can split, are 2.7e-4 of its long_500k cell
REPEAT_TOL = 5e-4
REPEAT_CELLS = [("deepseek_v3_671b", "decode_32k"),
                ("hymba_1p5b", "long_500k"), ("gemma_2b", "decode_32k")]


def _smoke_flops(arch, shape, dims):
    init_fake_world(math.prod(dims))
    try:
        mesh = _mesh(dims, ("data", "model"), torch.device("cpu"))
        rec = dryrun.run_cell(arch, shape, multi_pod=False, mesh=mesh)
    finally:
        destroy_world()
    assert rec["status"] == "ok", rec
    return rec["flops"]


@pytest.mark.parametrize("arch,shape", REPEAT_CELLS)
def test_smoke_decode_ranks_repeat_no_work(one_thread, monkeypatch, arch,
                                           shape):
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    one = _smoke_flops(arch, shape, (1, 1))
    eight = _smoke_flops(arch, shape, (2, 4))
    print(f"{arch} {shape}: FLOPs one rank {one:.0f}, a device of 8 "
          f"{eight:.0f}, ratio {8 * eight / one:.6f}")
    assert abs(8 * eight / one - 1) <= REPEAT_TOL
