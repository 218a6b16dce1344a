"""The port's Table 1 (``benchmarks/torch_table1_dynamic_training.py``)
against the reference's (``benchmarks/table1_dynamic_training.py``).

Both packages' ``run`` at the reference's smoke settings cut to 2 steps,
batch 2, then the memory-limit sweep at batch 3 under 1.05 x each
package's own disc++ batch-2 peak; the port starts from the reference's
weights (``params_from_jax``).  Per row: losses within 2e-4 per step,
``recompiles``, ``pad_frac`` and the ``oom`` flag equal.  The peaks
differ (the two captures decompose the step differently), so each
package sets its own limit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import params_from_jax

STEPS, BATCHES = 2, (2, 3)
TOL = 2e-4
# the rows of run(): three systems at BATCHES[0], then the sweep
ROWS = [(s, BATCHES[0]) for s in ("disc-dynamic", "disc-static", "disc++")] \
    + [(s, b) for b in BATCHES[1:] for s in ("disc-dynamic", "disc++")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    from benchmarks.table1_dynamic_training import run as ref_run
    from benchmarks.torch_table1_dynamic_training import run as port_run
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import init_params as ref_init

    cfg = get_smoke_config("llama2_1b")
    jcfg = dataclasses.replace(ref_smoke("llama2_1b"), scan_layers=False)
    weights = jax.tree.map(np.asarray, ref_init(jcfg, jax.random.PRNGKey(0)))
    ref = ref_run(steps=STEPS, batches=BATCHES)
    port = port_run(cfg, steps=STEPS, batches=BATCHES,
                    params=params_from_jax(weights, cfg, "cpu"),
                    device="cpu")
    return ref, port


@pytest.mark.parametrize("i", range(len(ROWS)),
                         ids=[f"{s}-b{b}" for s, b in ROWS])
def test_row_matches_reference(tables, i):
    ref, port = tables
    r, p = ref[i], port[i]
    assert (p["system"], p["batch"]) == (r["system"], r["batch"]) == ROWS[i]
    assert p["oom"] == r["oom"]
    assert p["recompiles"] == r["recompiles"]
    assert p["pad_frac"] == r["pad_frac"]
    assert (p["useful_tokens"], p["total_tokens"]) == \
        (r["useful_tokens"], r["total_tokens"])
    assert len(p["losses"]) == len(r["losses"]) == (0 if r["oom"] else STEPS)
    np.testing.assert_allclose(p["losses"], r["losses"], rtol=TOL, atol=TOL)
    if not p["oom"]:
        assert p["peak"] > 0
        assert p["memory_limit"] is None or p["peak"] <= p["memory_limit"]


def test_the_sweep_reproduces_the_oom_row(tables):
    """At the limit, disc-dynamic (no remat) runs out without evicting
    and disc++ fits; the two dynamic systems run the same ops on the same
    shapes, so their unlimited losses are equal bit for bit."""
    _, port = tables
    by = {(r["system"], r["batch"]): r for r in port}
    assert all(r["evictions"] == r["offloads"] == 0 for r in port
               if r["system"] == "disc-dynamic")
    limit = int(by[("disc++", BATCHES[0])]["peak"] * 1.05)
    for b in BATCHES[1:]:
        assert by[("disc-dynamic", b)]["oom"]
        assert not by[("disc++", b)]["oom"]
        assert by[("disc++", b)]["memory_limit"] == limit
    assert by[("disc++", BATCHES[0])]["losses"] == \
        by[("disc-dynamic", BATCHES[0])]["losses"]


def test_static_recompiles_once_per_padded_shape(tables):
    """disc-static compiles once per distinct power-of-two shape the
    pipeline pads to; its pad fraction is the padded pipeline's."""
    from repro_torch.data import DataPipeline, PipelineConfig
    _, port = tables
    row = next(r for r in port if r["system"] == "disc-static")
    cfg = get_smoke_config("llama2_1b")
    pipe = DataPipeline(PipelineConfig(vocab=cfg.vocab, batch_size=BATCHES[0],
                                       mode="bucketed", min_tokens=16,
                                       max_tokens=128))
    batches = [pipe.next_batch() for _ in range(STEPS)]
    shapes = {b["tokens"].shape for b in batches}
    assert row["recompiles"] == len(shapes)
    useful = sum(int(b["mask"].sum()) for b in batches)
    total = sum(b["tokens"].size for b in batches)
    assert row["pad_frac"] == 1.0 - useful / total

