"""The port's trainer and its substrate against the reference's.

* **Data pipeline** (``repro_torch.data``): batches (dynamic and
  bucketed), ``state``/``restore``, epoch rollover and ``padding_waste``
  equal to the reference's element for element.
* **Straggler monitor**: the same hosts flagged at the same steps on the
  same seeded time series.
* **Checkpointer**: twins of the reference's four single-device tests
  (``tests/test_substrate.py``), a bf16 + ``AdamWState`` round trip that
  must be bitwise, and an async failure surfacing at ``wait()``.
* **Trainer**: twins of ``tests/test_system.py``'s dynamic-trainer tests
  (loss decreases without retracing, the limit holds with the same
  losses, resume is exact); and one masked
  train step of ``build_dynamic_step`` on a pipeline batch against the
  reference's step on the same weights (loss and parameters within 2e-4,
  each moment leaf within a relative error norm of 1e-3).
* The new scripts import neither jax nor the reference package.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataPipeline, PipelineConfig
from repro_torch.distributed import StragglerConfig, StragglerMonitor
from repro_torch.launch.train import build_dynamic_step, to_device, train
from repro_torch.models import opt_state_from_jax, params_from_jax
from repro_torch.optim import AdamWState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_smoke_config("llama2-1b")
TOL = 2e-4
# the updated moments' relative error norm per leaf: AdamW's first update
# is about +-lr whatever the gradient's scale, so the parameters cannot
# see a wrongly scaled gradient; m (error 0.5) and v (0.75) see one
# scaled by 0.5
MOMENT_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- data pipeline -------------------------------------------------------------

PIPE_CASES = [
    dict(vocab=100, batch_size=4, seed=7),
    dict(vocab=100, batch_size=4, seed=1, mode="bucketed"),
    dict(vocab=512, batch_size=14, seed=0),
    dict(vocab=512, batch_size=8, seed=0, min_tokens=16, max_tokens=96),
    dict(vocab=50, batch_size=64, n_samples=100, seed=0),   # rolls over
]


@pytest.mark.parametrize("kw", PIPE_CASES, ids=str)
def test_pipeline_equals_reference(kw):
    from repro.data import DataPipeline as RPipe
    from repro.data import PipelineConfig as RConfig
    p, r = DataPipeline(PipelineConfig(**kw)), RPipe(RConfig(**kw))
    for _ in range(6):
        got, want = p.next_batch(), r.next_batch()
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert p.state() == r.state()
    assert p.padding_waste(50) == r.padding_waste(50)
    assert p.state() == r.state()
    # resume from the cursor on a fresh pipeline of each package
    state = p.state()
    q, rq = DataPipeline(PipelineConfig(**kw)), RPipe(RConfig(**kw))
    q.restore(state)
    rq.restore(state)
    want = p.next_batch()
    for got in (q.next_batch(), rq.next_batch()):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["mask"], want["mask"])


def test_pipeline_epoch_rollover():
    from repro.data import DataPipeline as RPipe
    from repro.data import PipelineConfig as RConfig
    kw = dict(vocab=50, batch_size=64, n_samples=100, seed=0)
    p, r = DataPipeline(PipelineConfig(**kw)), RPipe(RConfig(**kw))
    for _ in range(5):
        np.testing.assert_array_equal(p.next_batch()["tokens"],
                                      r.next_batch()["tokens"])
    assert p.state() == r.state() and p.state()["epoch"] >= 1
    assert DataPipeline.bucket_len(100) == RPipe.bucket_len(100) == 128


# -- straggler monitor -----------------------------------------------------------


def _series(kind, step, h):
    rs = np.random.RandomState(step * 10 + h)
    if kind == "quiet":
        return 1.0 + 0.02 * rs.rand()
    t = 1.0 + 0.01 * rs.rand()
    if kind == "one_slow" and step > 10 and h == 3:
        return 2.5
    if kind == "two_slow" and step > 6 and h in (1, 6):
        return 1.5 + 0.5 * rs.rand()
    return t


@pytest.mark.parametrize("kind", ["quiet", "one_slow", "two_slow"])
def test_straggler_flags_the_same_hosts(kind):
    from repro.distributed.straggler import StragglerConfig as RConfig
    from repro.distributed.straggler import StragglerMonitor as RMonitor
    port, ref = StragglerMonitor(), RMonitor()
    tight, rtight = StragglerMonitor(StragglerConfig(z_threshold=2.0,
                                                     patience=2)), \
        RMonitor(RConfig(z_threshold=2.0, patience=2))
    flagged = []
    for step in range(30):
        times = {h: _series(kind, step, h) for h in range(8)}
        got = port.record_step(times)
        assert got == ref.record_step(times)
        assert tight.record_step(times) == rtight.record_step(times)
        flagged += got
    hosts = list(range(8))
    assert port.healthy_hosts(hosts) == ref.healthy_hosts(hosts)
    assert flagged == {"quiet": [], "one_slow": [3],
                       "two_slow": [1, 6]}[kind]


# -- checkpointer ------------------------------------------------------------------


class TestCheckpointer:
    def test_save_restore_roundtrip(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep=2)
        state = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                 "opt": {"m": torch.ones(3, dtype=torch.float64),
                         "step": torch.tensor(7)}}
        ck.save(10, state, extra={"data_cursor": 42})
        step, got, extra = ck.restore(device="cpu")
        assert step == 10 and extra["data_cursor"] == 42
        assert torch.equal(got["w"], state["w"])
        assert torch.equal(got["opt"]["m"], state["opt"]["m"])
        assert got["opt"]["step"].dtype == torch.int64
        assert int(got["opt"]["step"]) == 7

    def test_keep_n_gc(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, {"x": torch.zeros(2)})
        assert ck.all_steps() == [3, 4]

    def test_async_save(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep=3)
        x = torch.arange(5)
        ck.save(5, {"x": x}, blocking=False)
        x.add_(100)        # the snapshot was taken before save returned
        ck.wait()
        assert ck.latest_step() == 5
        _, got, _ = ck.restore(device="cpu")
        assert torch.equal(got["x"], torch.arange(5))
        assert [s["step"] for s in ck.saves] == [5]
        assert ck.saves[0]["bytes"] == 5 * 8

    def test_atomic_no_partial_on_existing(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, {"x": torch.ones(3)})
        ck.save(1, {"x": torch.zeros(3)})  # overwrite same step atomically
        _, got, _ = ck.restore(1, device="cpu")
        assert torch.equal(got["x"], torch.zeros(3))
        assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]

    def test_bf16_and_adamw_state_round_trip_bitwise(self, tmp_path):
        gen = torch.Generator().manual_seed(0)
        params = {"embed": torch.randn(7, 5, generator=gen).bfloat16(),
                  "layers": [{"w": torch.randn(5, 3, generator=gen)
                              .bfloat16()}
                             for _ in range(2)]}
        params["embed"][0, 0] = float("nan")
        params["embed"][0, 1] = -0.0
        opt = AdamWState(step=torch.tensor(3, dtype=torch.int32),
                         m=pytree.tree_map(lambda p: p.float() * 1e-3,
                                           params),
                         v=pytree.tree_map(lambda p: p.float() ** 2, params))
        state = {"params": params, "opt_state": opt}
        ck = Checkpointer(str(tmp_path))
        ck.save(3, state, extra={"pipeline": {"cursor": 9, "epoch": 0,
                                              "seed": 0}})
        step, got, extra = ck.restore(device="cpu")
        assert step == 3 and extra["pipeline"]["cursor"] == 9
        assert isinstance(got["opt_state"], AdamWState)
        want_l, want_spec = pytree.tree_flatten(state)
        got_l, got_spec = pytree.tree_flatten(got)
        assert got_spec == want_spec
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        for g, w in zip(got_l, want_l):
            assert g.dtype == w.dtype and g.shape == w.shape
            bits = ints[w.element_size()]
            assert torch.equal(g.view(bits), w.view(bits))

    def test_async_failure_raises_at_wait(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, {"x": torch.ones(2)}, extra={"bad": object()},
                blocking=False)
        with pytest.raises(RuntimeError, match="async checkpoint save"):
            ck.wait()
        assert ck.all_steps() == []


# -- trainer -------------------------------------------------------------------


@pytest.fixture(scope="module")
def full_run():
    """12 uninterrupted steps, batch 4 (shared by the twins below)."""
    return train(CFG, steps=12, batch_size=4, log_every=100, device="cpu")


def test_loss_decreases(full_run):
    stats = full_run
    first = np.mean(stats["losses"][:3])
    last = np.mean(stats["losses"][-3:])
    assert last < first, (first, last)
    assert stats["recompilations"] == 0, "dynamic path must never retrace"
    assert stats["tokens"] > 0 and stats["peak_bytes"] > 0


def test_memory_limit_enforced():
    free = train(CFG, steps=4, batch_size=4, log_every=100, device="cpu")
    limit = int(free["peak_bytes"] * 0.7)
    lim = train(CFG, steps=4, batch_size=4, memory_limit=limit,
                log_every=100, device="cpu")
    assert lim["peak_bytes"] <= limit
    # numerics unchanged by remat
    assert lim["losses"] == free["losses"]


def test_checkpoint_resume_exact(full_run, tmp_path):
    d = str(tmp_path / "ck")
    # run 5 steps with a checkpoint at 5, then "crash" and resume
    part = train(CFG, steps=5, batch_size=4, ckpt_dir=d, ckpt_every=5,
                 log_every=100, device="cpu")
    assert [c["step"] for c in part["checkpoints"]] == [5]
    resumed = train(CFG, steps=10, batch_size=4, ckpt_dir=d, ckpt_every=5,
                    log_every=100, device="cpu")
    # the resumed run's steps 6..10 match the uninterrupted run exactly
    assert resumed["losses"] == full_run["losses"][5:10]
    assert part["losses"] == full_run["losses"][:5]
    assert Checkpointer(d).all_steps() == [5, 10]


def test_masked_train_step_matches_reference():
    """One step of the trainer's ``build_dynamic_step`` on a pipeline batch
    (with its label mask) against the reference's train step on the same
    weights and state: loss and updated parameters within 2e-4, and the
    updated moments ``m`` and ``v``, which carry the gradient's scale,
    within ``MOMENT_TOL`` per leaf."""
    from repro.configs import get_smoke_config as ref_smoke
    from repro.launch.steps import adamw_config_for as ref_adamw
    from repro.launch.steps import make_train_step as ref_step
    from repro.models import init_params as ref_init
    from repro.optim import init_state as ref_init_state

    jcfg = dataclasses.replace(ref_smoke("llama2_1b"), scan_layers=False)
    jparams = ref_init(jcfg, jax.random.PRNGKey(0))
    jopt = ref_init_state(jparams, ref_adamw(jcfg))
    pipe = DataPipeline(PipelineConfig(vocab=CFG.vocab, batch_size=3, seed=5,
                                       min_tokens=16, max_tokens=96))
    raw = pipe.next_batch()
    assert raw["mask"].min() == 0.0     # padded rows and the last column
    jloss, jnew, jnew_opt = jax.jit(ref_step(jcfg))(
        jparams, jopt, {k: jnp.asarray(raw[k])
                        for k in ("tokens", "labels", "mask")})
    np_params = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(np_params, CFG, "cpu")
    opt_state = opt_state_from_jax(jax.tree.map(np.asarray, jopt), CFG,
                                   "cpu")
    fn = build_dynamic_step(CFG, params, opt_state, device="cpu")
    loss, new, new_opt = fn.call_donated(
        [params, opt_state, to_device(raw, torch.device("cpu"))])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL, atol=TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jnew), CFG, "cpu")
    for g, w in zip(pytree.tree_leaves(new), pytree.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)
    assert int(new_opt.step) == 1
    want_opt = opt_state_from_jax(jax.tree.map(np.asarray, jnew_opt), CFG,
                                  "cpu")
    for field in ("m", "v"):
        got_leaves = pytree.tree_leaves_with_path(getattr(new_opt, field))
        want_leaves = pytree.tree_leaves(getattr(want_opt, field))
        for (path, g), w in zip(got_leaves, want_leaves):
            rel = ((g - w).norm() / w.norm()).item()
            assert rel <= MOMENT_TOL, (field, pytree.keystr(path), rel)


def test_new_scripts_import_neither_jax_nor_the_reference():
    code = (
        "import importlib.util, sys\n"
        "for name, path in [('t1', 'benchmarks/"
        "torch_table1_dynamic_training.py'), ('ex', 'examples/"
        "torch_train_dynamic_llama.py')]:\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.launch.train' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
