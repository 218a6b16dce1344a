"""The dry-run against a real reference lowering: the smoke
``kimi_k2_1t_a32b`` ``prefill_32k`` cell, one cell to keep the run cheap.
Its expert products run on each rank's own experts, dispatched and
combined by all-to-all as the reference's XLA does, so the port's
all-to-all bytes are held > 0 beside the reference's.  The FLOPs a
device agree within 1e-6 once the reference's repeat of the router
product on every model rank is added (``named_terms``).  The comparison
is ``test_torch_dryrun_ref.compare``; see there."""
import pytest
import torch

from test_torch_dryrun_ref import compare


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_kimi_k2_prefill_against_the_reference_lowering():
    compare("kimi_k2_1t_a32b", ["prefill_32k"])
