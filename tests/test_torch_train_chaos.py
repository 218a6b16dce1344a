"""Chaos on the train step of the reference's four bench archs.

Twin of ``tests/test_resilience.py``'s
``test_chaos_schedule_no_crash_and_bitwise_survivors`` (its
``chaos_arch_fn``): the port's smoke train step of ``llama2_1b``,
``gemma_2b``, ``granite_8b`` and ``musicgen_medium``
(``test_torch_bench_archs.step_and_specs``) under ``optimize`` with
``s`` buckets at 16 and 64, the retry ladder, the breaker and the
enforced arena bound; at envs (1,16), (2,40), (3,64) with arguments from
``concretize`` (seed 0) and ``FaultPlan.random`` seeds 0, 1, 2 over 8
calls: every survivor is bitwise equal to the fault-free run and within
its arena bound, every fired fault is on record, every failure is a
``RequestFailed`` with events, and every bucket heals.  The prefill chaos
on the smoke models is in ``test_torch_resilience.py``.
"""
import time

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import optimize
from repro_torch.core.resilience import (BreakerConfig, FaultPlan,
                                         RequestFailed, ResilienceConfig,
                                         RetryPolicy)
from test_torch_bench_archs import BENCH_ARCHS, concretize, step_and_specs

CHAOS_SEEDS = [0, 1, 2]
TRAIN_CHAOS_ENVS = [{"b": 1, "s": 16}, {"b": 2, "s": 40}, {"b": 3, "s": 64}]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees_equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def train_chaos_fn():
    """Per bench arch, one capture of the smoke train step
    (``test_torch_bench_archs.step_and_specs``), bucketed and resilient as
    ``tests/test_resilience.py``'s ``chaos_arch_fn``: (fn, arguments per
    env from ``concretize`` with seed 0, fault-free outputs per env)."""
    cache = {}

    def build(arch):
        if arch not in cache:
            r = step_and_specs(arch)
            assert r is not None, f"{arch} missing from the bench arch set"
            step, args = r
            fn = optimize(step, *args,
                          dynamic_dims={"b": (1, 4), "s": (8, 64)},
                          buckets={"s": [16, 64]}, device="cpu",
                          resilience=ResilienceConfig(
                              retry=RetryPolicy(max_retries=3,
                                                backoff_base_s=0.0),
                              breaker=BreakerConfig(backoff_s=0.01),
                              enforce_arena_bound=True))
            flat_specs, tree = pytree.tree_flatten(args)
            rng = np.random.RandomState(0)
            calls = [pytree.tree_unflatten(
                [concretize(sp, env, rng) for sp in flat_specs], tree)
                for env in TRAIN_CHAOS_ENVS]
            # the fault-free pass (also makes the bucket plans resident)
            refs = [fn(*c) for c in calls]
            cache[arch] = (fn, calls, refs)
        return cache[arch]

    return build


@pytest.mark.parametrize("arch", BENCH_ARCHS)
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_train_chaos_schedule_no_crash_and_bitwise_survivors(
        train_chaos_fn, arch, seed):
    """Twin of ``tests/test_resilience.py``'s chaos test on the train step
    of every bench arch: a seeded fault schedule crashes nothing, every
    survivor is bitwise equal to the fault-free run and within its arena
    bound, every fired fault is on record, every failure is a
    ``RequestFailed`` with events, and every bucket heals."""
    fn, calls, refs = train_chaos_fn(arch)
    table = fn.specialization_table
    keys = sorted({table.key_of(env) for env in TRAIN_CHAOS_ENVS})
    # drop resident plans so compile faults have compiles to hit
    with table._lock:
        for key in keys:
            table._plans.pop(key, None)
    res = fn.enable_resilience(ResilienceConfig(
        retry=RetryPolicy(max_retries=3, backoff_base_s=0.0),
        breaker=BreakerConfig(backoff_s=0.01), enforce_arena_bound=True))
    plan = FaultPlan.random(seed, n_faults=4, max_call=8, max_step=3,
                            buckets=keys, timeout_delay_s=0.0)
    failures = []
    with fn.inject_faults(plan):
        for i in range(8):
            k = i % len(TRAIN_CHAOS_ENVS)
            try:
                out = fn(*calls[k])
            except RequestFailed as e:
                failures.append((i, e))
                continue
            assert _trees_equal(out, refs[k]), \
                f"{arch} seed {seed} call {i}: outputs diverged"
            assert fn.last_report.stats.arena_bytes <= fn.last_arena_bound
    for i, e in failures:
        assert isinstance(e, RequestFailed)
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
    deadline = time.monotonic() + 5.0
    while table.quarantined() and time.monotonic() < deadline:
        time.sleep(0.02)
        for c, ref in zip(calls, refs):
            assert _trees_equal(fn(*c), ref)
    assert table.quarantined() == [], \
        f"{arch} seed {seed}: buckets still quarantined after recovery"
    for env, c, ref in zip(TRAIN_CHAOS_ENVS, calls, refs):
        assert _trees_equal(fn(*c), ref)
        assert table.peek(table.key_of(env)) is not None
