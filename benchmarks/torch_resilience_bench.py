"""Resilience benchmark on the PyTorch port (the twin of
``benchmarks/resilience_bench.py``): the disabled path's overhead
contract, and what degradation and recovery cost.

Measured surfaces:

* **overhead contract** — on the dispatch-chain microbench (256 tiny ops,
  the reference's ``CHAIN_OPS``), interleaved single-call samples with
  the ladder never attached, attached then detached, and enabled but
  healthy (``disabled_over_base`` / ``enabled_over_disabled``, reported).
  The hard <=2% contract is on the deterministic decomposition: the
  disabled hot path's only added work is the ``self._resilience is None``
  check, timed in isolation against the measured call;
* **degraded-path cost** — a call that takes one transient-fault retry
  at its first compute against the healthy call on the same plan
  (``degraded_over_healthy``: the retry repeats only the work before the
  fault, plus the ladder's bookkeeping, so at a fault before the first op
  the two medians differ by bookkeeping and noise), and the ops each
  dispatches, counted (``degraded_ops`` >= ``healthy_ops``);
* **quarantine recovery** — a bucket whose specialization an injected
  compile fault failed, then healed: ``recovery_s`` is the wall time from
  the fault clearing until the specialized plan is resident again
  (breaker backoff + one re-probe compile);
* **fault accounting** — seeded chaos schedules; ``faults_mapped_frac``
  is the share of fired faults that left a degradation event or a breaker
  transition (the chaos check asserts 1.0).

    PYTHONPATH=src python benchmarks/torch_resilience_bench.py [--smoke]
        [--device cpu] [--json FILE]

On the card it writes ``BENCH_torch_resilience.json`` with the card's name
and power limit; ``chip_smoke.py`` phase 13 runs ``overhead``,
``degraded_cost``, ``recovery`` and ``chaos`` on the full-width llama2_1b
prefill.  Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import TensorSpec, optimize, symbolic_dims
from repro_torch.core.api import resolve_device
from repro_torch.core.resilience import (BreakerConfig, FaultPlan, FaultSpec,
                                         RequestFailed, ResilienceConfig,
                                         RetryPolicy)

CHAIN_OPS = 256                   # benchmarks/exec_bench.py's chain length
ROUNDS = 100                      # interleaved single-call samples per label
OVERHEAD_TOL = 1.02               # the <=2% contract
CHECK_ITERS = 100_000

_NO_BACKOFF = RetryPolicy(max_retries=2, backoff_base_s=0.0)


def _sampler(fn, args: Sequence[Any]) -> Callable[[], float]:
    """Seconds of one call, ending in a device synchronize on the card."""
    dev = next((a.device for a in pytree.tree_leaves(tuple(args))
                if isinstance(a, torch.Tensor) and a.device.type == "cuda"),
               None)

    def sample() -> float:
        t0 = time.perf_counter()
        fn(*args)
        if dev is not None:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0
    return sample


def overhead(fn, args: Sequence[Any], rounds: int) -> Dict[str, Any]:
    """The disabled check's cost against ``fn``'s call (hard: <= 2%), and
    interleaved single-call samples of never attached / attached then
    detached / enabled but healthy (medians and minima, reported).
    ``fn`` must have no ladder attached."""
    if fn.resilience is not None:
        raise ValueError("overhead() needs a function without the ladder")
    sample = _sampler(fn, args)
    for _ in range(5):
        sample()
    sinks: Dict[str, List[float]] = {"base": [], "dis": [], "en": []}
    labels = list(sinks)
    cfg = ResilienceConfig(retry=_NO_BACKOFF)
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        for r in range(rounds):
            k = r % 3
            for label in labels[k:] + labels[:k]:
                if label == "en":
                    fn.enable_resilience(cfg)
                sinks[label].append(sample())
                if label == "en":
                    if fn.resilience.counters()["degraded_calls"]:
                        raise AssertionError("a healthy call degraded")
                    fn.disable_resilience()
    finally:
        if gc_was_enabled:
            gc.enable()
    med = {k: statistics.median(v) for k, v in sinks.items()}
    low = {k: min(v) for k, v in sinks.items()}
    # the hard contract: the disabled hot path's added work is exactly
    # one attribute load + `is None` test — time that in isolation
    t0 = time.perf_counter()
    for _ in range(CHECK_ITERS):
        res = fn._resilience
        if res is not None:
            raise AssertionError("resilience unexpectedly enabled")
    check_ns = (time.perf_counter() - t0) / CHECK_ITERS * 1e9
    check_frac = check_ns / (med["dis"] * 1e9)
    if check_frac > OVERHEAD_TOL - 1:
        raise AssertionError(
            f"the disabled resilience check costs {check_ns:.1f} ns = "
            f"{100 * check_frac:.4f}% of a {1e6 * med['dis']:.1f} us call "
            f"(contract <= {100 * (OVERHEAD_TOL - 1):.0f}%)")
    return dict(
        rounds=rounds,
        base_call_us=1e6 * med["base"], disabled_call_us=1e6 * med["dis"],
        enabled_call_us=1e6 * med["en"],
        base_call_min_us=1e6 * low["base"],
        disabled_call_min_us=1e6 * low["dis"],
        enabled_call_min_us=1e6 * low["en"],
        disabled_check_ns=check_ns, disabled_check_frac=check_frac,
        disabled_over_base=med["dis"] / med["base"],
        enabled_over_disabled=med["en"] / med["dis"])


def degraded_cost(fn, args: Sequence[Any], rounds: int) -> Dict[str, Any]:
    """One transient-fault retry (a ``kernel`` fault at the first compute)
    against the healthy call on the same plan, in turns.  Attaches a
    no-backoff ladder to ``fn``."""
    res = fn.enable_resilience(ResilienceConfig(retry=_NO_BACKOFF))
    sample = _sampler(fn, args)
    for _ in range(3):
        sample()
    healthy, degraded = [], []
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        for _ in range(rounds):
            healthy.append(sample())
            # exactly one kernel fault for the next resilient call
            fn._fault_ref.plan = FaultPlan(
                [FaultSpec("kernel", call=None, step=0)])
            degraded.append(sample())
            fn._fault_ref.plan = None
    finally:
        if gc_was_enabled:
            gc.enable()
    c = res.counters()
    if c["retries_transient"] != rounds or c["failures"]:
        raise AssertionError(f"faults did not all fire and recover: {c}")
    # the work itself, counted rather than timed: a fault at the first
    # compute repeats nothing, so the two medians differ by bookkeeping
    # and noise, while the degraded call runs every op the healthy one does
    healthy_ops = _ops_of(lambda: fn(*args))
    fn._fault_ref.plan = FaultPlan([FaultSpec("kernel", call=None, step=0)])
    degraded_ops = _ops_of(lambda: fn(*args))
    fn._fault_ref.plan = None
    c = res.counters()
    if c["retries_transient"] != rounds + 1 or c["failures"]:
        raise AssertionError(f"the counted fault did not recover: {c}")
    med_h, med_d = statistics.median(healthy), statistics.median(degraded)
    return dict(degraded_rounds=rounds, healthy_call_us=1e6 * med_h,
                degraded_call_us=1e6 * med_d,
                degraded_over_healthy=med_d / med_h,
                degraded_over_healthy_min=min(degraded) / min(healthy),
                retries_transient=c["retries_transient"] - 1,
                failures=c["failures"], healthy_ops=healthy_ops,
                degraded_ops=degraded_ops)


def _ops_of(call: Callable[[], Any]) -> int:
    """The operator calls (aten and custom ops) that ``call`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as counter:
        call()
    return counter.n


def recovery(fn, args: Sequence[Any], kind: str = "compile",
             equal: Optional[Callable[[Any], bool]] = None
             ) -> Dict[str, Any]:
    """Quarantine and heal the bucket of ``args`` on a bucketed function
    with the ladder attached: drop its resident plan, fail its next compile
    with a ``kind`` fault (served by the whole-range fallback), then serve
    until the breaker's re-probe makes the specialized plan resident again.
    ``recovery_s`` runs from the fault clearing to that moment.  ``equal``
    checks each output (the fallback's and the healed plan's)."""
    table = fn.specialization_table
    fn(*args)
    key = fn.last_bucket
    with table._lock:
        table._plans.pop(key, None)
    fp = FaultPlan([FaultSpec(kind, bucket=key)])
    res = fn.resilience
    before = res.counters()["retries_fallback"]
    with fn.inject_faults(fp):
        out = fn(*args)            # the compile fails -> the fallback
    if equal is not None and not equal(out):
        raise AssertionError("the fallback's output differs")
    del out
    if [f.kind for f in fp.fired] != [kind] or \
            table.breaker.state(key) != "open":
        raise AssertionError(f"the {kind} fault did not open the breaker")
    served = 0
    t0 = time.perf_counter()
    while table.peek(key) is None:
        out = fn(*args)
        served += 1
        if equal is not None and not equal(out):
            raise AssertionError("an output during the outage differs")
        del out
        time.sleep(0.001)
    recovery_s = time.perf_counter() - t0
    if table.breaker.state(key) != "closed" or table.quarantined():
        raise AssertionError("the bucket did not heal")
    out = fn(*args)
    if fn.last_arena_bound != table.arena_bound_bytes(key) or (
            equal is not None and not equal(out)):
        raise AssertionError("the healed bucket did not serve the call")
    return dict(kind=kind, bucket=list(key),
                breaker_backoff_s=table.breaker.config.backoff_s,
                recovery_s=recovery_s, calls_during_outage=served,
                fallback_retries=res.counters()["retries_fallback"] - before)


def chaos(fn, calls: Sequence[Sequence[Any]], equal: Sequence[Callable],
          seed: int, *, n_calls: int = 8, max_call: int = 8,
          max_step: int = 3, memory: Optional[Callable[[], int]] = None
          ) -> Dict[str, Any]:
    """One seeded schedule (``FaultPlan.random``, compile faults on the
    buckets of ``calls``) over ``n_calls`` calls cycling ``calls`` on a
    bucketed function with the ladder attached, the garbage collector off.

    Hard: no exception but ``RequestFailed`` escapes, every survivor passes
    its ``equal`` check, every ``RequestFailed`` carries events, every
    survivor's arena is within the bound of the plan that ran it, every
    fired fault left an event or an ``open`` breaker transition,
    ``memory()`` (the card's ``memory_allocated``) is back at its level
    after every failed call, and every bucket heals once the schedule is
    spent."""
    table = fn.specialization_table
    keys = sorted({_key_of(fn, args) for args in calls})
    with table._lock:            # compile faults need compiles to hit
        for key in keys:
            table._plans.pop(key, None)
    # a fresh controller (call ordinals from 0); the breaker and the arena
    # caps are the table's and the executors', fixed by optimize
    res = fn.enable_resilience(ResilienceConfig(
        retry=RetryPolicy(max_retries=3, backoff_base_s=0.0)))
    plan = FaultPlan.random(seed, n_faults=4, max_call=max_call,
                            max_step=max_step, buckets=keys,
                            timeout_delay_s=0.0)
    failures = []
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        with fn.inject_faults(plan):
            for i in range(n_calls):
                k = i % len(calls)
                m0 = memory() if memory is not None else 0
                try:
                    out = fn(*calls[k])
                except RequestFailed as e:
                    if not e.events:
                        raise AssertionError(
                            f"the failure at call {i} carries no events")
                    failures.append((i, e.attempts, type(e.cause).__name__))
                    del e
                    if memory is not None and memory() != m0:
                        raise AssertionError(
                            f"call {i} failed holding {memory() - m0} B")
                    continue
                if not equal[k](out):
                    raise AssertionError(f"seed {seed} call {i}: a "
                                         f"survivor's output differs")
                if fn.last_report.stats.arena_bytes > fn.last_arena_bound:
                    raise AssertionError(f"call {i}: arena above its bound")
                del out
    finally:
        if gc_was_enabled:
            gc.enable()
    evs = list(res.events)
    mapped = 0
    for f in plan.fired:
        if f.kind in ("compile", "compile-timeout"):
            mapped += any(t["key"] == f.bucket and t["state"] == "open"
                          for t in table.breaker.transitions)
        else:
            mapped += any(e.seq == f.call for e in evs)
    frac = mapped / len(plan.fired) if plan.fired else 1.0
    if frac != 1.0:
        raise AssertionError(f"seed {seed}: a fired fault left no record")
    # recovery: with the schedule spent every bucket heals once its backoff
    # has passed and a request re-probes it
    t0 = time.perf_counter()
    deadline = time.monotonic() + 5.0
    while table.quarantined() and time.monotonic() < deadline:
        time.sleep(0.02)
        for k, args in enumerate(calls):
            if not equal[k](fn(*args)):
                raise AssertionError("an output during recovery differs")
    heal_s = time.perf_counter() - t0
    if table.quarantined():
        raise AssertionError(f"seed {seed}: buckets still quarantined")
    for k, args in enumerate(calls):
        if not equal[k](fn(*args)) or table.peek(fn.last_bucket) is None:
            raise AssertionError("a bucket did not return to its plan")
    return dict(seed=seed, calls=n_calls,
                fired=[(f.kind, f.call, f.bucket) for f in plan.fired],
                failures=failures, events=[(e.rung, e.seq, e.attempt)
                                           for e in evs],
                faults_mapped_frac=frac, heal_s=heal_s)


def _key_of(fn, args):
    from repro_torch.core.ir.capture import solve_env
    return fn.specialization_table.key_of(
        solve_env(fn.plan.graph, pytree.tree_leaves(tuple(args))))


# -- the microbench ----------------------------------------------------------


def chain_fn(device):
    n, = symbolic_dims("n")

    def chain(x):
        for _ in range(CHAIN_OPS // 2):
            x = x * 1.0000001 + 0.5
        return x

    return optimize(chain, TensorSpec((n,), torch.float32),
                    dynamic_dims={"n": (8, 4096)}, device=device)


def bucketed_fn(device, backoff_s: float):
    b, = symbolic_dims("b")

    def f(w, x):
        h = torch.tanh(x @ w)
        return (h * h).sum()

    return optimize(f, TensorSpec((8, 8), torch.float32),
                    TensorSpec((b, 8), torch.float32),
                    dynamic_dims={"b": (1, 512)}, buckets={"b": [8, 64, 512]},
                    device=device, resilience=ResilienceConfig(
                        retry=_NO_BACKOFF,
                        breaker=BreakerConfig(backoff_s=backoff_s),
                        enforce_arena_bound=True))


def run(smoke: bool = False, device: Any = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    rounds = 20 if smoke else ROUNDS
    row: Dict[str, Any] = dict(arch="resilience_micro", n_ops=CHAIN_OPS,
                               device=dev.type)
    x = torch.arange(64, dtype=torch.float32, device=dev)
    row.update(overhead(chain_fn(dev), (x,), rounds))
    row.update(degraded_cost(chain_fn(dev), (x,), max(10, rounds // 2)))
    fn = bucketed_fn(dev, 0.02)
    w = torch.ones(8, 8, device=dev)
    xs = torch.ones(4, 8, device=dev)
    row.update(recovery(fn, (w, xs)))
    seeds = (0,) if smoke else (0, 1, 2)
    fired = failures = 0
    for seed in seeds:
        fn = bucketed_fn(dev, 0.01)
        calls = [(w, torch.ones(n, 8, device=dev)) for n in (4, 32, 200)]
        want = [fn(*c) for c in calls]
        r = chaos(fn, calls, [lambda o, t=t: torch.equal(o, t) for t in want],
                  seed, n_calls=6, max_call=6, max_step=2,
                  memory=torch.cuda.memory_allocated
                  if dev.type == "cuda" else None)
        fired += len(r["fired"])
        failures += len(r["failures"])
    row.update(chaos_seeds=list(seeds), chaos_calls=6 * len(seeds),
               chaos_fired=fired, chaos_failures=failures,
               faults_mapped_frac=1.0)
    row["smoke"] = smoke
    return row


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="fewer rounds and one chaos seed")
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu: run on the CPU)")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="write the row here (on the card default: "
                         "BENCH_torch_resilience.json at the repo root)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    smi = nvidia_smi() if dev.type == "cuda" else None
    if smi:
        print(smi, flush=True)
    row = run(smoke=args.smoke, device=dev)
    print(f"{row['arch']} on {dev.type}: check {row['disabled_check_ns']:.1f}"
          f" ns ({100 * row['disabled_check_frac']:.4f}% of a call, "
          f"contract <= 2%); degraded/healthy "
          f"{row['degraded_over_healthy']:.3f}x; recovery "
          f"{1e3 * row['recovery_s']:.1f} ms; faults mapped "
          f"{100 * row['faults_mapped_frac']:.0f}%")
    out = args.json
    if out is None and dev.type == "cuda":
        out = Path(__file__).resolve().parent.parent / \
            "BENCH_torch_resilience.json"
    if out is not None:
        with open(out, "w") as f:
            json.dump({"nvidia_smi": smi, "device": str(dev),
                       "rows": [row]}, f, indent=1)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
