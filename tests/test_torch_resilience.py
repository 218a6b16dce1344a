"""The port's resilience layer against the reference's (``repro/core/resilience``).

Twin of ``tests/test_resilience.py``:

* **Same schedule.** ``FaultPlan.random`` with the same arguments yields
  the same specs in both packages.
* **Same ladder.** The reference's small f32 train step (V 300, D 32,
  F 64) written in torch, weights from the same numpy arrays, bucketed at
  ``s`` 32 / 256: under the same fault plans both packages record the same
  ``(rung, seq, attempt, bucket)`` events, fire the same ``(kind, call,
  bucket)`` faults and fail the same requests after as many attempts;
  every survivor is within 2e-4 of JAX's output and bitwise equal to the
  port's own fault-free run.
* **The ladder.** Transient retry in place, alloc -> bitwise fallback,
  exponential injectable backoff, structured exhaustion, malformed without
  retry, events in the ``DecisionLog``, enable/disable; a
  ``torch.cuda.OutOfMemoryError`` from an op lands on ``retry-fallback``,
  any other error from an op propagates; ``ArenaExhausted`` under
  ``enforce_arena_bound``; compile faults quarantine and heal.
* **Chaos** on the smoke ``llama2_1b`` and ``gemma_2b`` prefill: seeded
  schedules crash nothing, survivors are bitwise, every fired fault is on
  record, buckets heal, arenas stay under the active bound.
* **Disabled path and threads.** ``tracemalloc`` sees no allocation from
  resilience code with the ladder off; concurrent calls lose no counts.
* **The benchmark twin.** ``benchmarks/torch_resilience_bench.py --smoke``
  on the CPU.
"""
import dataclasses
import os
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.core as R
import repro.core.resilience as RR
import repro_torch.core.resilience as res_pkg
from repro_torch.core import TensorSpec, optimize, spec_like, symbolic_dims
from repro_torch.core.memplan.arena import ArenaAllocator, ArenaExhausted
from repro_torch.core.resilience import (BreakerConfig, CompileTimeout,
                                         FaultPlan, FaultSpec, RequestFailed,
                                         ResilienceConfig, RetryPolicy,
                                         TransientKernelError)
from repro_torch.launch.serve import BucketBatcher
from test_resilience import concrete_params
from test_resilience import specs as j_specs
from test_resilience import tokens_of
from test_resilience import train_step as j_train_step

DIMS = {"b": (1, 16), "s": (8, 256)}
BUCKETS = {"s": [32, 256]}
FAST_RETRY = dict(max_retries=2, backoff_base_s=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the reference's small train step, in torch --------------------------------


def loss_fn(params, tokens, labels):
    emb = F.embedding(tokens, params["emb"])
    h = F.gelu(emb @ params["w1"], approximate="tanh")   # jax.nn.gelu
    logits = (h @ params["w2"]) @ params["emb"].T
    logp = torch.log_softmax(logits, -1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).mean()


def train_step(params, tokens, labels):
    with torch.enable_grad():
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = loss_fn(leaves, tokens, labels)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), {k: p - 1e-3 * g
                           for (k, p), g in zip(params.items(), grads)}


def t_params(seed=0):
    return {k: torch.from_numpy(np.array(v))
            for k, v in sorted(concrete_params(seed).items())}


def t_tokens(b, s, seed=1):
    return torch.from_numpy(np.array(tokens_of(b, s, seed)))


def t_args(b, s):
    return t_params(), t_tokens(b, s), t_tokens(b, s)


def j_args(b, s):
    return concrete_params(), tokens_of(b, s), tokens_of(b, s)


def t_specs():
    b, s = symbolic_dims("b, s")
    return (spec_like(t_params()), TensorSpec((b, s), torch.int32),
            TensorSpec((b, s), torch.int32))


def t_optimize(**kw):
    return optimize(train_step, *t_specs(), dynamic_dims=DIMS,
                    device="cpu", **kw)


def leaves(out):
    loss, params = out
    return [np.asarray(loss)] + [np.asarray(params[k])
                                 for k in sorted(params)]


def bitwise(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(np.array_equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.fixture()
def resilient_fn():
    """Whole-range fn with the ladder attached (fresh per test: the
    controller and fault bookkeeping are the object under test)."""
    return t_optimize(resilience=ResilienceConfig(
        retry=RetryPolicy(**FAST_RETRY)))


@pytest.fixture()
def bucketed_resilient_fn():
    return t_optimize(buckets=BUCKETS, resilience=ResilienceConfig(
        retry=RetryPolicy(**FAST_RETRY),
        breaker=BreakerConfig(backoff_s=0.02), enforce_arena_bound=True))


# -- the schedule --------------------------------------------------------------


def test_unknown_kind_rejected():
    with pytest.raises(ValueError):
        FaultSpec("meteor-strike")
    with pytest.raises(ValueError):
        FaultSpec("kernel", times=0)


@pytest.mark.parametrize("seed", [0, 1, 7, 8])
def test_random_schedule_equals_reference(seed):
    kw = dict(n_faults=6, max_call=8, max_step=4, buckets=[(0,), (1,)],
              timeout_delay_s=0.0)
    port = FaultPlan.random(seed, **kw)
    ref = RR.FaultPlan.random(seed, **kw)
    assert [vars(s) for s in port.specs] == [vars(s) for s in ref.specs]
    assert [vars(s) for s in FaultPlan.random(seed, **kw).specs] == \
        [vars(s) for s in port.specs]


def test_arming_spends_the_budget_once():
    fp = FaultPlan([FaultSpec("kernel", call=3)])
    assert fp.arm_call(0) is None
    armed = fp.arm_call(3)
    assert armed is not None and not armed.needs_memory
    with pytest.raises(TransientKernelError):
        armed.before_compute()
    assert fp.remaining() == 0 and fp.arm_call(3) is None
    assert [(f.kind, f.call, f.seq) for f in fp.fired] == [("kernel", 3, 0)]
    assert FaultPlan([FaultSpec("offload", call=0)]).arm_call(0).needs_memory
    cf = FaultPlan([FaultSpec("compile", bucket=(1,))])
    cf.check_compile((0,))                 # another bucket: nothing fires
    with pytest.raises(res_pkg.CompileFault):
        cf.check_compile((1,))
    cf.check_compile((1,))                 # budget spent
    assert cf.fired[0].bucket == (1,)


# -- the same ladder as the reference -----------------------------------------

LADDER_CALLS = [(2, 24), (3, 48), (2, 16), (4, 200), (1, 8), (3, 100)]
LADDER_PLANS = {
    **{f"random-{seed}": seed for seed in range(6)},
    "transient-x2": [dict(kind="kernel", call=1, step=2, times=2)],
    "exhausted": [dict(kind="kernel", call=0, step=0, times=5)],
    "alloc": [dict(kind="alloc", call=2, step=1),
              dict(kind="malformed-env", call=4)],
    # the wider bucket's compile fails twice, the narrower's times out
    "compile": [dict(kind="compile", bucket=-1, times=2),
                dict(kind="compile-timeout", bucket=0)],
}


def _plan(mod, case, keys):
    spec = LADDER_PLANS[case]
    if isinstance(spec, int):
        return mod.FaultPlan.random(spec, n_faults=4, max_call=6, max_step=3,
                                    buckets=keys, timeout_delay_s=0.0)
    return mod.FaultPlan([mod.FaultSpec(**{
        **s, **({"bucket": keys[s["bucket"]]} if "bucket" in s else {})})
        for s in spec])


def _walk(mod, fn, plan, calls):
    """Serve ``calls`` under ``plan`` on a fresh controller; the ladder's
    record and each call's output or attempts."""
    res = fn.enable_resilience(mod.ResilienceConfig(
        retry=mod.RetryPolicy(**FAST_RETRY)))
    outcomes = []
    with fn.inject_faults(plan):
        for args in calls:
            try:
                outcomes.append(fn(*args))
            except mod.RequestFailed as e:
                assert e.events, "a RequestFailed without events"
                outcomes.append(e.attempts)
    return ([(e.rung, e.seq, e.attempt, e.bucket) for e in res.events],
            [(f.kind, f.call, f.bucket) for f in plan.fired], outcomes)


@pytest.mark.parametrize("case", list(LADDER_PLANS))
def test_same_ladder_as_reference(case):
    # a breaker backoff that outlasts the test: the sequence is then
    # independent of timing, in both packages
    breaker = dict(backoff_s=600.0, max_backoff_s=600.0)
    jfn = R.optimize(j_train_step, *j_specs(), dynamic_dims=DIMS,
                     buckets=BUCKETS, resilience=RR.ResilienceConfig(
                         breaker=RR.BreakerConfig(**breaker)))
    tfn = t_optimize(buckets=BUCKETS, resilience=ResilienceConfig(
        breaker=BreakerConfig(**breaker)))
    keys = sorted({tfn.specialization_table.key_of({"b": b, "s": s})
                   for b, s in LADDER_CALLS})
    assert keys == sorted({jfn.specialization_table.key_of({"b": b, "s": s})
                           for b, s in LADDER_CALLS})
    j_calls = [j_args(b, s) for b, s in LADDER_CALLS]
    t_calls = [t_args(b, s) for b, s in LADDER_CALLS]
    clean = t_optimize()
    t_clean = [clean(*a) for a in t_calls]
    j_ev, j_fired, j_out = _walk(RR, jfn, _plan(RR, case, keys), j_calls)
    t_ev, t_fired, t_out = _walk(res_pkg, tfn, _plan(res_pkg, case, keys),
                                 t_calls)
    assert t_ev == j_ev
    assert t_fired == j_fired
    assert len(t_fired) > 0
    for i, (jo, to) in enumerate(zip(j_out, t_out)):
        if isinstance(jo, int):
            assert to == jo, f"call {i}: attempts differ"
            continue
        assert bitwise(to, t_clean[i]), f"call {i}: survivor not bitwise"
        for a, b in zip(leaves(to), leaves(jo)):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


# -- the ladder ----------------------------------------------------------------


def test_no_fault_path_matches_plain(resilient_fn):
    args = t_args(4, 32)
    assert bitwise(resilient_fn(*args), t_optimize()(*args))
    assert resilient_fn.resilience.counters()["degraded_calls"] == 0


def test_transient_kernel_fault_retries_in_place(resilient_fn):
    args = t_args(4, 32)
    ref = resilient_fn(*args)
    fp = FaultPlan([FaultSpec("kernel", call=1, step=2)])
    with resilient_fn.inject_faults(fp) as res:
        out = resilient_fn(*args)
    assert bitwise(out, ref)
    c = res.counters()
    assert c["retries_transient"] == 1 and c["degraded_calls"] == 1
    assert c["failures"] == 0
    evs = list(res.events)
    assert [e.rung for e in evs] == ["retry-transient"]
    assert "kernel" in evs[0].cause
    assert [f.kind for f in fp.fired] == ["kernel"]


def test_alloc_fault_falls_back_bitwise(bucketed_resilient_fn):
    fn = bucketed_resilient_fn
    args = t_args(2, 24)
    ref = fn(*args)
    assert fn.last_bucket is not None
    bucket_bound = fn.last_arena_bound
    fp = FaultPlan([FaultSpec("alloc", call=1, step=0)])
    with fn.inject_faults(fp) as res:
        out = fn(*args)
    assert bitwise(out, ref)                # the fallback is bitwise equal
    c = res.counters()
    assert c["retries_fallback"] == 1 and c["failures"] == 0
    assert [e.rung for e in res.events] == ["retry-fallback"]
    # the retry ran the whole-range plan, held to its own bound
    assert fn.last_arena_bound == fn.arena_bound_bytes >= bucket_bound
    assert fn.last_report.stats.arena_bytes <= fn.last_arena_bound


def test_backoff_is_exponential_and_injectable(resilient_fn):
    slept = []
    res = resilient_fn.enable_resilience(ResilienceConfig(
        retry=RetryPolicy(max_retries=2, backoff_base_s=0.01,
                          backoff_factor=4.0)))
    res.sleep = slept.append
    resilient_fn._fault_ref.plan = FaultPlan(
        [FaultSpec("kernel", call=0, step=0, times=2)])
    resilient_fn(*t_args(2, 16))
    assert slept == [pytest.approx(0.01), pytest.approx(0.04)]


def test_retries_exhausted_raises_structured(resilient_fn):
    args = t_args(3, 16)
    fp = FaultPlan([FaultSpec("kernel", call=0, step=0, times=5)])
    with resilient_fn.inject_faults(fp) as res:
        with pytest.raises(RequestFailed) as ei:
            resilient_fn(*args)
    e = ei.value
    assert e.attempts == 3               # max_retries=2 -> 3 attempts
    assert e.env == {"b": 3, "s": 16}
    assert isinstance(e.cause, TransientKernelError)
    assert e.__cause__ is e.cause
    assert [ev.rung for ev in e.events] == \
        ["retry-transient", "retry-transient", "reject"]
    assert [ev.attempt for ev in e.events] == [0, 1, 2]
    assert res.counters()["failures"] == 1
    resilient_fn(*args)                  # the budget was spent on the failure
    assert res.counters()["failures"] == 1


def test_malformed_request_rejected_without_retry(resilient_fn):
    fp = FaultPlan([FaultSpec("malformed-env", call=0)])
    with resilient_fn.inject_faults(fp) as res:
        with pytest.raises(RequestFailed) as ei:
            resilient_fn(*t_args(2, 16))
    assert ei.value.attempts == 0
    assert [ev.rung for ev in ei.value.events] == ["reject-malformed"]
    c = res.counters()
    assert c["malformed"] == 1 and c["failures"] == 1
    assert c["retries_transient"] == 0 and c["retries_fallback"] == 0


def test_degrade_events_land_in_decision_log(resilient_fn):
    fp = FaultPlan([FaultSpec("kernel", call=0, step=0)])
    with resilient_fn.inject_faults(fp):
        resilient_fn(*t_args(2, 16))
    degrades = resilient_fn.decisions.entries("degrade")
    assert [(d.subject, d.choice) for d in degrades] == \
        [("call 0", "retry-transient")]


def test_enable_disable_roundtrip(resilient_fn):
    res = resilient_fn.disable_resilience()
    assert res is not None and resilient_fn.resilience is None
    resilient_fn(*t_args(2, 16))         # the plain path works
    res2 = resilient_fn.enable_resilience()
    assert resilient_fn.resilience is res2 and res2 is not res
    assert "not enabled" not in resilient_fn.explain()
    # inject_faults attaches a controller for its block only
    resilient_fn.disable_resilience()
    with resilient_fn.inject_faults(FaultPlan()) as tmp:
        assert resilient_fn.resilience is tmp
    assert resilient_fn.resilience is None
    assert "not enabled" in resilient_fn.explain()


def _patch_compute(monkeypatch, program, pick, make_prim):
    """Replace the op of ``program``'s ``pick``-th compute by
    ``make_prim(op)`` (in both streams: they share the instruction)."""
    from repro_torch.core.lowering.program import OP_COMPUTE
    inst = [x for x in program.fast_instructions if x.op == OP_COMPUTE][pick]
    patched = dataclasses.replace(inst, prim=make_prim(inst.prim))
    for name in ("fast_instructions", "instructions"):
        monkeypatch.setattr(program, name, [
            patched if x is inst else x for x in getattr(program, name)])


def _failing(make_error, times):
    left = [times]

    def make(op):
        def prim(*args, **kwargs):
            if left[0] > 0:
                left[0] -= 1
                raise make_error()
            return op(*args, **kwargs)
        return prim
    return make, left


def test_a_real_oom_lands_on_retry_fallback(bucketed_resilient_fn,
                                            monkeypatch):
    fn = bucketed_resilient_fn
    args = t_args(2, 24)
    ref = fn(*args)
    bp = fn.specialization_table.peek(fn.last_bucket)
    make, left = _failing(
        lambda: torch.cuda.OutOfMemoryError("out of memory"), 1)
    _patch_compute(monkeypatch, bp.program, 0, make)
    out = fn(*args)
    assert left == [0] and bitwise(out, ref)
    evs = list(fn.resilience.events)
    assert [e.rung for e in evs] == ["retry-fallback"]
    assert "OutOfMemoryError" in evs[0].cause
    assert fn.last_arena_bound == fn.arena_bound_bytes


def test_another_error_from_an_op_propagates(bucketed_resilient_fn,
                                             monkeypatch):
    fn = bucketed_resilient_fn
    args = t_args(2, 24)
    fn(*args)
    bp = fn.specialization_table.peek(fn.last_bucket)
    make, _ = _failing(lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered"), 1)
    _patch_compute(monkeypatch, bp.program, 0, make)
    with pytest.raises(RuntimeError, match="illegal memory") as ei:
        fn(*args)
    assert not isinstance(ei.value, RequestFailed)
    c = fn.resilience.counters()
    assert c["degraded_calls"] == 0 and list(fn.resilience.events) == []


def test_a_failed_attempt_holds_no_tensor(bucketed_resilient_fn,
                                          monkeypatch):
    """With the garbage collector off, what a failed attempt computed is
    gone once the ladder moves on, also while the caller holds the
    RequestFailed (on the card: ``memory_allocated()`` back at its
    level)."""
    import gc
    import weakref
    from torch.utils import _pytree as pytree
    fn = bucketed_resilient_fn
    args = t_args(2, 24)
    fn(*args)
    inputs = {id(t) for t in pytree.tree_leaves(args)}
    made = []

    def failing(op):
        def prim(*a, **kw):
            # the attempt's own tensors, alive in its registers right now
            made.extend(weakref.ref(t) for t in pytree.tree_leaves((a, kw))
                        if isinstance(t, torch.Tensor)
                        and id(t) not in inputs)
            raise torch.cuda.OutOfMemoryError("out of memory")
        return prim

    for program in (fn.specialization_table.peek(fn.last_bucket).program,
                    fn.program):
        _patch_compute(monkeypatch, program, -1, failing)
    enabled = gc.isenabled()
    gc.disable()
    try:
        with pytest.raises(RequestFailed) as ei:
            fn(*args)
        assert ei.value.attempts == 3 and made
        assert [r for r in made if r() is not None] == []
    finally:
        if enabled:
            gc.enable()


def test_arena_exhausted_under_enforce_arena_bound(bucketed_resilient_fn):
    # the allocator: a placement past the cap raises and rolls back
    fn = bucketed_resilient_fn
    plan = fn.plan.arena_plan
    env = {"b": 2, "s": 24}
    alloc = ArenaAllocator(plan, plan.resolve(env), hard_cap=1)
    vid = next(v for v, a in plan.assignment.items()
               if not plan.resolve(env).external[a.sid])
    with pytest.raises(ArenaExhausted):
        alloc.alloc(vid, 64)
    assert alloc.in_use_bytes == 0 and vid not in alloc.slot_of
    # the ladder: a bucket runner held below its plan's reserve raises
    # ArenaExhausted, and the whole-range plan serves the call bitwise
    args = t_args(2, 24)
    ref = fn(*args)
    runner = fn.specialization_table.peek(fn.last_bucket).interp
    assert runner.arena_hard_cap == fn.last_arena_bound
    runner.arena_hard_cap = 1
    out = fn(*args)
    assert bitwise(out, ref)
    evs = list(fn.resilience.events)
    assert [e.rung for e in evs] == ["retry-fallback"]
    assert "ArenaExhausted" in evs[0].cause
    assert fn.last_report.stats.arena_bytes <= fn.last_arena_bound


# -- quarantined specialization -------------------------------------------------


def test_compile_fault_quarantines_then_heals():
    fn = t_optimize(buckets=BUCKETS, resilience=ResilienceConfig(
        retry=RetryPolicy(**FAST_RETRY),
        breaker=BreakerConfig(backoff_s=0.05)))
    args = t_args(2, 24)
    ref = t_optimize()(*args)
    table = fn.specialization_table
    fp = FaultPlan([FaultSpec("compile")])
    with fn.inject_faults(fp) as res:
        assert bitwise(fn(*args), ref)     # compile fails -> fallback
        assert res.counters()["retries_fallback"] == 1
        key = fp.fired[0].bucket
        assert table.breaker.state(key) == "open"
        assert table.quarantined() == [key]
        assert bitwise(fn(*args), ref)     # quarantined: the fallback serves
        assert table.stats()["specialize_count"] == 0
    time.sleep(0.06)                       # after the backoff: a re-probe
    assert bitwise(fn(*args), ref)
    assert table.breaker.state(key) == "closed"
    assert table.quarantined() == []
    assert table.stats()["specialize_count"] == 1
    assert table.peek(key) is not None


def test_compile_timeout_detected_and_quarantined():
    fn = t_optimize(buckets=BUCKETS, resilience=ResilienceConfig(
        retry=RetryPolicy(**FAST_RETRY),
        breaker=BreakerConfig(backoff_s=5.0), compile_timeout_s=0.001))
    fp = FaultPlan([FaultSpec("compile-timeout", delay_s=0.01)])
    with fn.inject_faults(fp) as res:
        fn(*t_args(2, 24))                  # slow compile -> fallback
    table = fn.specialization_table
    key = fp.fired[0].bucket
    assert table.breaker.state(key) == "open"
    assert isinstance(table.breaker.cause(key), CompileTimeout)
    assert res.counters()["retries_fallback"] == 1
    # the config's deadline reaches the table: a real compile slower than
    # it is discarded and quarantined too
    assert table.compile_timeout_s == 0.001


def test_quarantine_visible_in_exports():
    fn = t_optimize(buckets=BUCKETS, resilience=ResilienceConfig(
        retry=RetryPolicy(**FAST_RETRY),
        breaker=BreakerConfig(backoff_s=5.0)))
    with fn.inject_faults(FaultPlan([FaultSpec("compile")])):
        fn(*t_args(2, 24))
    from repro_torch.core.obs import prometheus_text
    text = prometheus_text(fn=fn)
    assert "repro_quarantined_buckets 1" in text
    assert 'repro_retries_total{rung="fallback"} 1' in text
    report = fn.explain()
    assert "-- resilience" in report and "quarantined bucket" in report
    assert "retry-fallback" in report and "max_retries=2" in report


def test_chaos_through_serve_loop():
    """``BucketBatcher.process``: a RequestFailed becomes a structured
    outcome carrying its events; nothing escapes."""
    fn = t_optimize(buckets=BUCKETS, resilience=ResilienceConfig(
        retry=RetryPolicy(**FAST_RETRY)))
    bat = BucketBatcher(fn)
    args = t_args(2, 24)
    ref = fn(*args)
    for _ in range(3):
        bat.submit({"b": 2, "s": 24}, payload=args)
    # the reference call above was seq 0; fault the middle queued one
    fp = FaultPlan([FaultSpec("malformed-env", call=2)])
    with fn.inject_faults(fp):
        outcomes = bat.process()
    assert [o["ok"] for o in outcomes] == [True, False, True]
    for o in outcomes:
        if o["ok"]:
            assert bitwise(o["value"], ref) and o["report"] is not None
        else:
            assert isinstance(o["error"], RequestFailed)
            assert o["error"].attempts == 0
            assert [e.rung for e in o["error"].events] == ["reject-malformed"]


# -- chaos on the smoke models -------------------------------------------------

CHAOS_ARCHS = ["llama2_1b", "gemma_2b"]
CHAOS_SEEDS = [0, 1, 2]
CHAOS_ENVS = [(1, 16), (2, 40), (3, 64)]


@pytest.fixture(scope="module")
def chaos_fn():
    """Per arch, one capture of the smoke prefill: (resilient bucketed fn,
    params, batch per env, fault-free outputs per env)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params
    cache = {}

    def build(arch):
        if arch not in cache:
            cfg = get_smoke_config(arch)
            params = init_params(cfg, seed=0, device="cpu")
            b, s = symbolic_dims("b, s")
            fn = optimize(make_prefill_step(cfg), spec_like(params),
                          {"tokens": TensorSpec((b, s), torch.int32)},
                          dynamic_dims={"b": (1, 4), "s": (8, 64)},
                          buckets={"s": [16, 64]}, device="cpu",
                          resilience=ResilienceConfig(
                              breaker=BreakerConfig(backoff_s=0.01),
                              enforce_arena_bound=True))
            rng = np.random.RandomState(0)
            batches = [{"tokens": torch.from_numpy(rng.randint(
                0, cfg.vocab, (b, s)).astype(np.int32))}
                for b, s in CHAOS_ENVS]
            refs = [fn(params, x) for x in batches]
            cache[arch] = (fn, params, batches, refs)
        return cache[arch]

    return build


@pytest.mark.parametrize("arch", CHAOS_ARCHS)
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_schedule_no_crash_and_bitwise_survivors(chaos_fn, arch, seed):
    fn, params, batches, refs = chaos_fn(arch)
    table = fn.specialization_table
    keys = sorted({table.key_of({"b": b, "s": s}) for b, s in CHAOS_ENVS})
    # drop resident plans so compile faults have compiles to hit
    with table._lock:
        for key in keys:
            table._plans.pop(key, None)
    res = fn.enable_resilience(ResilienceConfig(
        retry=RetryPolicy(max_retries=3, backoff_base_s=0.0)))
    plan = FaultPlan.random(seed, n_faults=4, max_call=8, max_step=3,
                            buckets=keys, timeout_delay_s=0.0)
    failures = []
    with fn.inject_faults(plan):
        for i in range(8):
            k = i % len(CHAOS_ENVS)
            try:
                out = fn(params, batches[k])
            except RequestFailed as e:
                failures.append((i, e))
                continue
            assert torch.equal(out, refs[k]), f"call {i}: outputs diverged"
            assert fn.last_report.stats.arena_bytes <= fn.last_arena_bound
    for i, e in failures:
        assert e.events, f"the failure at call {i} carries no events"
    evs = list(res.events)
    assert plan.fired
    for f in plan.fired:
        if f.kind in ("compile", "compile-timeout"):
            assert any(t["key"] == f.bucket and t["state"] == "open"
                       for t in table.breaker.transitions), \
                f"compile fault on {f.bucket} left no breaker transition"
        else:
            assert any(e.seq == f.call for e in evs), \
                f"{f.kind} fault on call {f.call} left no event"
    # recovery: with the schedule spent, every bucket heals once its
    # backoff has passed and a request re-probes it
    deadline = time.monotonic() + 5.0
    while table.quarantined() and time.monotonic() < deadline:
        time.sleep(0.02)
        for x, ref in zip(batches, refs):
            assert torch.equal(fn(params, x), ref)
    assert table.quarantined() == []
    for (b, s), x, ref in zip(CHAOS_ENVS, batches, refs):
        assert torch.equal(fn(params, x), ref)
        assert table.peek(table.key_of({"b": b, "s": s})) is not None


# -- the disabled path, threads ------------------------------------------------


def test_disabled_path_allocates_nothing_from_resilience():
    """The structural form of the <=2% contract: with the ladder off a
    call runs no resilience code (the wall-clock form is in
    ``benchmarks/torch_resilience_bench.py``)."""
    fn = t_optimize(buckets=BUCKETS)
    assert fn.resilience is None
    res_dir = os.path.dirname(res_pkg.__file__)
    args = t_args(2, 16)
    fn(*args)                                  # warm every cache
    flt = tracemalloc.Filter(True, os.path.join(res_dir, "*"))
    tracemalloc.start(5)
    try:
        before = tracemalloc.take_snapshot().filter_traces([flt])
        for _ in range(5):
            fn(*args)
        after = tracemalloc.take_snapshot().filter_traces([flt])
    finally:
        tracemalloc.stop()
    grew = [d for d in after.compare_to(before, "lineno") if d.size_diff > 0]
    assert not grew, f"resilience code allocated on the disabled path: {grew}"


def test_concurrent_calls_lose_no_counts():
    fn = t_optimize(buckets=BUCKETS, resilience=ResilienceConfig(
        retry=RetryPolicy(**FAST_RETRY)))
    tel = fn.enable_telemetry(capacity=1024)
    envs = [(2, 24), (3, 48), (2, 16)]
    per_thread, n_threads = 5, 6
    # every third call of the run takes one transient retry
    fn._fault_ref.plan = FaultPlan([FaultSpec("kernel", call=c, step=0)
                                    for c in range(0, 30, 3)])
    errs = []

    def work(tid):
        try:
            for i in range(per_thread):
                fn(*t_args(*envs[(tid + i) % len(envs)]))
        except Exception as e:      # surface it, do not deadlock
            errs.append(e)

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errs == []
    total = per_thread * n_threads
    c = fn.resilience.counters()
    assert c["calls"] == total
    assert c["retries_transient"] == c["degraded_calls"] == 10
    assert len(fn.resilience.events) == 10
    assert tel.n_calls == total and tel.ring.total_pushed == total


# -- the benchmark twin ---------------------------------------------------------


def test_resilience_bench_smoke_on_cpu():
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                        "torch_resilience_bench.py")
    spec = importlib.util.spec_from_file_location("torch_resilience", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    row = bench.run(smoke=True, device="cpu")
    assert row["device"] == "cpu" and row["smoke"]
    assert row["disabled_check_frac"] <= bench.OVERHEAD_TOL - 1
    assert row["degraded_over_healthy"] > 1.0
    assert row["recovery_s"] > 0 and row["faults_mapped_frac"] == 1.0
    assert row["chaos_fired"] > 0
