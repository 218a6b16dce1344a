"""The dry-run against a real reference lowering: smoke ``gemma_2b``, one
kv head, which the model axis of 4 does not divide (the flash rule
gathers the heads).  The comparison, with its named terms and the train
cell's counts (both sides recompute each block in the backward), is
``test_torch_dryrun_ref.compare``;
see there."""
import pytest
import torch

from test_torch_dryrun_ref import compare


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gemma_2b_cells_against_the_reference_lowering():
    compare("gemma_2b")
