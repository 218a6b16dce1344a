"""Serving: the reference's KV-cache decode loop and the bucket-aware
front end.

``serve`` is the reference's server loop (``repro/launch/serve.py:345``):
a cache-filling prefill token (or frame) by token, then greedy decode,
every step through one plan of the port's ``decode_step`` that
``decode_plan`` builds with ``optimize`` over a symbolic batch, as the
reference runs them through one ``jax.jit``; ``python -m
repro_torch.launch.serve --arch gemma-2b`` runs it (any dense, MoE or
hybrid or xLSTM arch: ``musicgen-medium`` decodes frames into 4
codebooks, ``deepseek-v3-671b`` over MLA's latent cache, ``hymba-1.5b``
with an SSM state beside each layer's KV cache and its sliding windows,
``xlstm-1.3b`` over recurrent mLSTM / sLSTM states and no KV cache).

``BucketBatcher`` groups queued requests by specialization bucket before
dispatch, so one specialized plan — lowered to a flat executable
``Program`` run by the VM — serves each group, and admission control can
reason in per-bucket guaranteed arena bounds.  Port of the batcher of
``repro/launch/serve.py``, with its Prometheus export (``metrics_text``).
"""
from __future__ import annotations

import argparse
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core.api import (DynamicShapeFunction, optimize, resolve_device,
                        spec_like, symbolic_dims)
from ..core.obs import AdmissionEvent
from ..models import decode_step, init_cache, init_params
from .specs import cache_specs, decode_input_specs


# -- bucket-aware batching -----------------------------------------------------


@dataclass
class BucketGroup:
    """One drained batch: same-bucket requests dispatched together."""

    key: Tuple[int, ...]
    label: str                               # human-readable bucket ranges
    envs: List[Dict[str, int]]
    payloads: List[Any]
    # guaranteed worst-case arena size of the bucket's plan (None when the
    # bucket has an unbounded dim or memory_plan="none")
    arena_bound_bytes: Optional[int] = None
    # instruction count of the bucket's lowered Program when its plan is
    # resident (None: not yet compiled, or executor="reference") — an
    # observability hook: the group will run a flat executable, and this
    # is how long it is
    n_instructions: Optional[int] = None

    def __len__(self) -> int:
        return len(self.envs)


class BucketBatcher:
    """Groups queued requests into specialization buckets before dispatch.

    Serving traffic is shape-diverse; dispatching each request alone makes
    every shape a fresh arena resolve, and dispatching mixed shapes in
    arrival order ping-pongs between bucket plans.  The batcher instead
    queues ``(env, payload)`` requests, keyed by the bucket the env lands
    in (same O(log n) lookup the call path uses), and ``drain()`` returns
    same-bucket groups — buckets with a resident specialized plan first
    (so background specialization never blocks hot traffic), largest
    group first within each class.

    ``memory_budget`` enables admission control by bucket: a group whose
    bucket plan carries ``arena_bound_bytes`` above the budget stays
    queued (the bound is a *guarantee* — any request in the bucket fits
    under it), so the server can run small-shape traffic while deferring
    heavy buckets to a bigger worker or an off-peak window.

    Serve hardening (every knob defaults *off*, preserving the plain
    grouping behavior):

    * ``max_queue`` bounds the total queue; a full queue applies
      ``shed_policy`` — ``"reject-new"`` raises a structured
      :class:`~repro_torch.core.resilience.RequestRejected` at submit,
      ``"drop-oldest"`` evicts the oldest queued request instead.
    * ``default_deadline_s`` / ``submit(..., deadline_s=)`` attach a
      deadline; requests still queued when it expires are shed at the
      next drain (``shed-deadline``) instead of dispatching stale.
    * ``max_hold_cycles`` ages out over-budget groups: a group held more
      than this many drains is shed whole (``shed-aged``) rather than
      re-enqueued forever — the unbounded-requeue gap this closes.
      ``hold_backoff_s`` (doubled by ``hold_backoff_factor`` per
      consecutive hold, per bucket) keeps a held group quietly queued
      between re-checks instead of re-probing the bound every drain.

    Every shed is recorded: ``shed_count`` / ``shed_by_outcome``
    counters, an :class:`AdmissionEvent` with the matching ``outcome``,
    and the shed requests themselves retrievable via :meth:`take_shed`
    so a serve loop can answer those clients.
    """

    def __init__(self, fn, *, memory_budget: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject-new",
                 max_hold_cycles: Optional[int] = None,
                 hold_backoff_s: float = 0.0,
                 hold_backoff_factor: float = 2.0,
                 default_deadline_s: Optional[float] = None,
                 clock=time.monotonic):
        table = getattr(fn, "specialization_table", None)
        if table is None:
            raise ValueError(
                "BucketBatcher requires a bucketed function — build it with "
                "optimize(..., dynamic_dims=..., buckets=...)")
        if shed_policy not in ("reject-new", "drop-oldest"):
            raise ValueError(
                f"shed_policy must be 'reject-new' or 'drop-oldest', "
                f"got {shed_policy!r}")
        self.fn = fn
        self.table = table
        self.memory_budget = memory_budget
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.max_hold_cycles = max_hold_cycles
        self.hold_backoff_s = hold_backoff_s
        self.hold_backoff_factor = hold_backoff_factor
        self.default_deadline_s = default_deadline_s
        self._clock = clock
        # bucket key -> queued (env, payload, deadline_t), FIFO per bucket
        self._queue: "OrderedDict[Tuple[int, ...], List[Tuple[Dict[str, int], Any, Optional[float]]]]" = OrderedDict()
        # admission-control observability: cumulative hold count, per-bucket
        # breakdown, and the most recent structured events (bounded — a
        # perpetually-held bucket must not grow memory drain after drain)
        self.held_count = 0
        self.held_by_key: Dict[Tuple[int, ...], int] = {}
        self.admission_events: "deque[AdmissionEvent]" = deque(maxlen=256)
        # shed accounting: counters by outcome + the shed requests
        # themselves (bounded), retrievable once via take_shed()
        self.shed_count = 0
        self.shed_by_outcome: Dict[str, int] = {}
        self._shed: "deque[Tuple[Tuple[int, ...], Dict[str, int], Any, str]]" = deque(maxlen=256)
        # per-bucket hold aging: key -> [consecutive holds, next check t]
        self._hold_state: Dict[Tuple[int, ...], List[float]] = {}

    def _record_shed(self, key: Tuple[int, ...], reqs, outcome: str,
                     *, required: int = 0, available: int = 0) -> None:
        self.shed_count += len(reqs)
        self.shed_by_outcome[outcome] = \
            self.shed_by_outcome.get(outcome, 0) + len(reqs)
        self.admission_events.append(AdmissionEvent(
            key=key, label=self.table.space.describe(key),
            required_bytes=required, available_bytes=available,
            queue_depth=len(reqs), outcome=outcome))
        for env, payload, _dl in reqs:
            self._shed.append((key, env, payload, outcome))

    def _drop_oldest(self) -> None:
        """Evict the oldest queued request (the first request of the
        first-queued bucket) to make room for a new one."""
        for key in self._queue:
            reqs = self._queue[key]
            self._record_shed(key, reqs[:1], "shed-capacity")
            del reqs[0]
            if not reqs:
                del self._queue[key]
            return

    def submit(self, env: Mapping[str, int], payload: Any = None, *,
               deadline_s: Optional[float] = None) -> Tuple[int, ...]:
        """Queue one request; returns the bucket key it grouped under.

        An env outside the declared ranges raises here — at intake, where
        the client error belongs — rather than mid-drain after the group
        was admitted under a bucket bound the request does not satisfy.
        With ``max_queue`` set, a full queue sheds per ``shed_policy``:
        ``reject-new`` raises :class:`RequestRejected` (structured — the
        caller answers the client), ``drop-oldest`` evicts silently into
        :meth:`take_shed`.  ``deadline_s`` (default
        ``default_deadline_s``) bounds how long the request may wait.
        """
        key = self.table.key_of(env)
        if self.max_queue is not None and self.pending() >= self.max_queue:
            if self.shed_policy == "drop-oldest":
                self._drop_oldest()
            else:
                from ..core.resilience import RequestRejected
                self.shed_count += 1
                self.shed_by_outcome["shed-capacity"] = \
                    self.shed_by_outcome.get("shed-capacity", 0) + 1
                self.admission_events.append(AdmissionEvent(
                    key=key, label=self.table.space.describe(key),
                    required_bytes=0, available_bytes=0,
                    queue_depth=self.pending(), outcome="shed-capacity"))
                raise RequestRejected(
                    f"queue full ({self.max_queue} pending); request shed",
                    reason="shed-capacity", env=env, bucket=key)
        dl = deadline_s if deadline_s is not None else self.default_deadline_s
        deadline_t = None if dl is None else self._clock() + dl
        self._queue.setdefault(key, []).append(
            (dict(env), payload, deadline_t))
        return key

    def pending(self) -> int:
        return sum(len(reqs) for reqs in self._queue.values())

    def pending_by_bucket(self) -> Dict[Tuple[int, ...], int]:
        return {key: len(reqs) for key, reqs in self._queue.items()}

    def drain(self) -> List[BucketGroup]:
        """Admitted same-bucket groups — compiled buckets first, then by
        group size; held groups remain.

        Buckets whose specialized plan is already resident dispatch ahead
        of buckets that would still need a compile: with background
        specialization that keeps the worker serving specialized traffic
        at full speed while cold buckets finish compiling off-thread
        (their requests run on the whole-range fallback only if drained
        before the swap lands).  Within each class, largest group first.

        A group is held when ``memory_budget`` is set and the bucket's
        guaranteed arena bound exceeds it.  Admission asks the table for
        the bound, which compiles a bucket the *first* time it is ever
        seen (bounds are then remembered across plan eviction, so held
        buckets are not recompiled drain after drain) — in background
        mode it instead schedules the compile and admits against the
        conservative whole-range bound; use ``fn.warmup(envs)``
        beforehand to move even that first compile off the serving path.

        Hardening hooks (when configured): expired-deadline requests are
        shed before admission, a group inside its hold-backoff window
        stays queued without re-checking, and a group held more than
        ``max_hold_cycles`` drains is shed whole instead of re-enqueued
        indefinitely.
        """
        admitted: List[BucketGroup] = []
        held: "OrderedDict[Tuple[int, ...], List[Tuple[Dict[str, int], Any, Optional[float]]]]" = OrderedDict()
        now = self._clock()
        order = sorted(self._queue,
                       key=lambda k: (self.table.peek(k) is None,
                                      -len(self._queue[k])))
        for key in order:
            reqs = self._queue[key]
            # deadline shedding first: a request whose deadline passed in
            # queue must not dispatch stale, whatever its group's fate
            expired = [r for r in reqs if r[2] is not None and r[2] <= now]
            if expired:
                self._record_shed(key, expired, "shed-deadline")
                reqs = [r for r in reqs if not (r[2] is not None
                                                and r[2] <= now)]
                if not reqs:
                    self._hold_state.pop(key, None)
                    continue
            bound = self.table.arena_bound_bytes(key)
            if self.memory_budget is not None and bound is not None \
                    and bound > self.memory_budget:
                st = self._hold_state.get(key)
                if st is not None and now < st[1]:
                    held[key] = reqs      # inside the backoff window
                    continue
                cycles = int(st[0]) + 1 if st is not None else 1
                if self.max_hold_cycles is not None \
                        and cycles > self.max_hold_cycles:
                    # aged out: shed the whole group instead of holding
                    # it (and re-probing its bound) forever
                    self._record_shed(key, reqs, "shed-aged",
                                      required=bound,
                                      available=self.memory_budget)
                    self._hold_state.pop(key, None)
                    continue
                backoff = self.hold_backoff_s \
                    * (self.hold_backoff_factor ** (cycles - 1)) \
                    if self.hold_backoff_s else 0.0
                self._hold_state[key] = [cycles, now + backoff]
                # structured admission event: what was refused, what it
                # needed, what was available, and how deep its queue is —
                # the silent-hold observability gap this surface closes
                self.held_count += 1
                self.held_by_key[key] = self.held_by_key.get(key, 0) + 1
                self.admission_events.append(AdmissionEvent(
                    key=key, label=self.table.space.describe(key),
                    required_bytes=bound,
                    available_bytes=self.memory_budget,
                    queue_depth=len(reqs)))
                held[key] = reqs
                continue
            self._hold_state.pop(key, None)
            # resident plans carry their lowered Program; peek only — a
            # group must never force a compile just to report its length
            resident = self.table.peek(key)
            admitted.append(BucketGroup(
                key=key, label=self.table.space.describe(key),
                envs=[e for e, _, _ in reqs],
                payloads=[p for _, p, _ in reqs],
                arena_bound_bytes=bound,
                n_instructions=None if resident is None
                else resident.n_instructions))
        self._queue = held
        return admitted

    def take_shed(self) -> List[Tuple[Tuple[int, ...], Dict[str, int],
                                      Any, str]]:
        """Drain the shed-request record: ``(key, env, payload, outcome)``
        per shed request, oldest first.  A serve loop calls this after
        ``drain()`` to answer the clients whose requests were shed."""
        out = list(self._shed)
        self._shed.clear()
        return out

    def process(self, groups: Optional[List[BucketGroup]] = None
                ) -> List[Dict[str, Any]]:
        """Drain (unless given ``groups``) and run every admitted request
        through the function — the hardened serve inner loop.

        Each payload is treated as the request's call arguments (a tuple
        is splatted, anything else passed as the single argument).  Only
        the structured :class:`~repro_torch.core.resilience.RequestFailed` is
        caught — with resilience enabled one failing request yields a
        structured outcome instead of killing the loop, while unexpected
        exceptions still propagate loudly.  Returns one outcome dict per
        request: ``env``, ``bucket``, ``payload``, ``ok``, and ``value``
        + ``report`` + ``arena_bound`` (success) or ``error`` (failure).
        """
        from ..core.resilience import RequestFailed
        if groups is None:
            groups = self.drain()
        outcomes: List[Dict[str, Any]] = []
        for g in groups:
            for env, payload in zip(g.envs, g.payloads):
                base = {"env": env, "bucket": g.key, "payload": payload}
                try:
                    args = payload if isinstance(payload, tuple) \
                        else (payload,)
                    value = self.fn(*args)
                    outcomes.append(dict(
                        base, ok=True, value=value,
                        report=self.fn.last_report,
                        arena_bound=getattr(self.fn, "last_arena_bound",
                                            None)))
                except RequestFailed as e:
                    outcomes.append(dict(base, ok=False, error=e))
        return outcomes

    def metrics_text(self, prefix: str = "repro") -> str:
        """Prometheus text metrics for this batcher + its function:
        per-bucket hit/miss/arena-bound series and the admission-control
        counters (``held_total``, per-bucket holds, queue depth)."""
        from ..core.obs import prometheus_text
        return prometheus_text(fn=self.fn, batcher=self, prefix=prefix)


# -- the decode loop ------------------------------------------------------------


def decode_plan(cfg, params: Dict[str, Any], *, max_len: int,
                max_batch: int = 8, device: Any = None
                ) -> DynamicShapeFunction:
    """``decode_step`` as one ``optimize`` plan: captured once with the
    batch ``b`` symbolic in ``[1, max_batch]``, the cache of ``max_len``
    rows (``cache_specs``) and the weights as arguments, so one plan runs
    a step at any batch in range.  Nothing is donated (``donate_inputs``
    is all or nothing, and the weights outlive the call), so the plan's
    ``device_peak`` holds the old state and the new one.  A step that
    capture refuses raises here: there is no eager fallback."""
    b, = symbolic_dims("b")
    return optimize(lambda p, s, i: decode_step(cfg, p, s, i),
                    spec_like(params), cache_specs(cfg, b, max_len),
                    decode_input_specs(cfg, b),
                    dynamic_dims={"b": (1, max_batch)}, device=device)


def serve(cfg, *, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          seed: int = 0, greedy: bool = True,
          device: Any = None) -> Dict[str, Any]:
    """The reference's server loop: random weights from ``seed``, a prompt
    from ``np.random.RandomState(seed)`` fed one step at a time to fill a
    cache of ``prompt_len + gen + 1`` rows, then ``gen`` greedy decode
    steps.  The prompt is tokens, or in ``embeddings`` mode (musicgen)
    standard-normal f32 frames; a codebook head's argmax is taken per
    codebook, (B, K), and a zero frame is fed after it, as the reference
    does (``repro/launch/serve.py:352-378``; ``vlm`` decodes text tokens
    without a vision prefix, as there).  A prompt step's token or frame
    enters the plan as a contiguous copy (a frame in the model's dtype,
    the step's first cast), as the plan was captured on contiguous
    arguments.

    Every step runs through one ``decode_plan`` (``b`` symbolic in
    ``[1, max(8, batch)]``), as the reference runs them through one
    ``jax.jit``; the plan is built before the prefill and its seconds are
    ``compile_s``.  Runs on ``device`` (``cuda`` unless given) and waits
    for the device after the prefill and after every decode step, where
    the reference blocks.

    Returns the reference's keys (``prefill_s``, ``decode_s``,
    ``decode_tok_per_s``, ``tokens`` (B, gen) or (B, gen, K)),
    ``compile_s``, ``prompt`` (B, prompt_len) tokens or (B, prompt_len, D)
    frames, ``prompt_logits`` (the logits after the last prompt step,
    (B, 1, V) or (B, 1, K, V)), ``state`` (the final ``DecodeState``) and
    ``step`` (the plan every step ran through)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    params = init_params(cfg, seed=seed, device=dev)
    max_len = prompt_len + gen + 1
    t_c = time.perf_counter()
    step = decode_plan(cfg, params, max_len=max_len,
                       max_batch=max(8, batch), device=dev)
    compile_s = time.perf_counter() - t_c
    state = init_cache(cfg, batch, max_len=max_len, device=dev)
    if cfg.input_mode == "embeddings":
        prompt = rng.randn(batch, prompt_len, cfg.d_model).astype(np.float32)
        frames = torch.from_numpy(prompt).to(dev).to(cfg.torch_dtype)

        def feed(t):
            return {"frame_embed": frames[:, t:t + 1].contiguous()}
    else:
        prompt = rng.randint(1, cfg.vocab, (batch, prompt_len))
        prompt_toks = torch.from_numpy(prompt).to(torch.int32).to(dev)

        def feed(t):
            return {"token": prompt_toks[:, t:t + 1].contiguous()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):           # cache-filling prefill
        logits, state = step(params, state, feed(t))
    sync()
    prefill_s = time.perf_counter() - t0
    prompt_logits = logits

    out_tokens = []
    t1 = time.perf_counter()
    for _ in range(gen):
        nxt = torch.argmax(logits[:, -1], dim=-1)        # (B,) or (B, K)
        out_tokens.append(nxt.cpu().numpy())
        if cfg.n_codebooks:
            inp = {"frame_embed": torch.zeros(
                (batch, 1, cfg.d_model), dtype=cfg.torch_dtype, device=dev)}
        else:
            inp = {"token": nxt[:, None].to(torch.int32)}
        logits, state = step(params, state, inp)
        sync()
    decode_s = time.perf_counter() - t1
    return {
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "decode_tok_per_s": batch * gen / max(decode_s, 1e-9),
        "tokens": np.stack(out_tokens, axis=1) if out_tokens else None,
        "compile_s": compile_s,
        "prompt": prompt,
        "prompt_logits": prompt_logits,
        "state": state,
        "step": step,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    r = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
              gen=args.gen, device=args.device)
    print(f"[serve] compile {r['compile_s']:.1f} s, "
          f"prefill {r['prefill_s']*1000:.0f} ms, "
          f"decode {r['decode_tok_per_s']:.1f} tok/s")
    if r["tokens"] is not None:
        print("[serve] sample:", r["tokens"][0][:10].tolist())


if __name__ == "__main__":
    main()
