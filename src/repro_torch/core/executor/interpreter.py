"""Op-by-op executor of an ExecutionPlan — the BladeDISC++ runtime analogue.

Port of ``repro/core/executor/interpreter.py``: the oracle the lowered
``ProgramVM`` is held against (``optimize(..., executor="reference")``).
It executes the scheduled graph on concrete tensors of *any* shape
matching the symbolic trace (one capture, no padding, no recompile), with
dict storage keyed by value id and everything re-derived per op:

  * exact memory accounting through ``MemoryManager``;
  * the evict check at op boundaries (paper's ``Remat::EvictOp``);
  * materialize-on-demand regeneration (paper's ``Remat::RegenerateOp``),
    by recompute subgraph or host reload, chosen by the runtime policy.

Recompute-evicted tensors place a *hold* on each source of their recompute
subgraph, so sources stay materializable (alive, offloaded, or recursively
recomputable) until regeneration releases the hold.  Evicting a root also
drops its live views, which are rebuilt over the regenerated root when
read (see ``executor.vm``).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..ir.capture import (Arg, check_declared_ranges, override_template,
                          resolve_leaves, solve_env)
from ..ir.dynamism import complete_bound_env
from ..ir.graph import Node, Value
from ..ir.loop import loop_body_of
from ..memplan.arena import ArenaAllocator
from ..remat.planner import ExecutionPlan
from ..remat.runtime import RuntimeRematPolicy
from ..symbolic.expr import SymbolicExpr
from .memory import MemoryManager
from .vm import RunReport, call_op, offload, reload, take


class PlanInterpreter:
    def __init__(self, plan: ExecutionPlan, *,
                 memory_limit: Optional[int] = None,
                 donate_inputs: bool = False,
                 count_inputs: bool = True,
                 arena_hard_cap: Optional[int] = None):
        self.plan = plan
        self.g = plan.graph
        self.memory_limit = memory_limit
        self.donate_inputs = donate_inputs
        self.count_inputs = count_inputs
        # resilience.enforce_arena_bound (see ProgramVM.arena_hard_cap)
        self.arena_hard_cap = arena_hard_cap
        self._output_ids = {v.id for v in self.g.outputs}
        self._value_by_id = {v.id: v for v in self.g.values}
        self._remaining_template: Dict[int, int] = {
            v.id: len([c for c in v.consumers if c.id in plan.pos])
            for v in self.g.values
        }
        self._views_of: Dict[int, List[int]] = {}
        for v in self.g.values:
            if v.base is not None:
                self._views_of.setdefault(v.base.id, []).append(v.id)
        # argument templates: the node's own, or with this plan's kernel
        # variant baked in (the shared ``node.params`` stay untouched:
        # other buckets' plans choose their own variants)
        self._templates: Dict[int, Tuple[List[Any], Any]] = {
            n.id: override_template(n, plan.kernel_overrides.get(n.id))
            for n in self.g.nodes if loop_body_of(n) is None}
        # values whose byte size mentions a bounded dim, and nodes whose
        # arguments do: both are re-evaluated per call at the live env
        # (the measured value) and never enter the per-env caches
        names = frozenset(self.g.bound_dims)
        self._bound_dep_vids = {v.id for v in self.g.values
                                if v.nbytes_expr.free_vars() & names}
        self._bound_dep_nodes = {
            nid for nid, (leaves, _spec) in self._templates.items()
            if any(isinstance(x, SymbolicExpr) and x.free_vars() & names
                   for x in leaves)}
        # per-env caches reused across calls (training repeats shapes)
        self._size_cache: Dict[Tuple, Dict[int, int]] = {}
        self._leaves_cache: Dict[Tuple, Dict[int, List[Any]]] = {}
        # optional live-occupancy probe (see ProgramVM.timeline_hook):
        # called as hook(step, node, mm) after every executed node
        self.timeline_hook = None

    # ---------------------------------------------------------------- run --
    def run(self, flat_args: List[Any],
            env: Optional[Dict[str, int]] = None,
            faults: Any = None) -> Tuple[List[Any], RunReport]:
        t0 = time.perf_counter()
        g, plan = self.g, self.plan
        if env is None:
            env = solve_env(g, flat_args)
            check_declared_ranges(plan.shape_graph, env)
        # keyed by the *declared* env: bounded dims complete to caps
        # deterministically, and measured values stay out of the caches
        key = tuple(sorted(env.items()))
        env_decl = env
        env = complete_bound_env(g, env) if g.bound_dims else env
        # the live env: each BindDim step rebinds its bounded dim here
        # mid-call (a private copy; ``env`` keeps the caps)
        env_run = dict(env) if g.bound_dims else env
        bound_dep = self._bound_dep_vids
        if len(self._size_cache) > 64:  # bound the per-shape caches
            self._size_cache.clear()
            self._leaves_cache.clear()
        nbytes = self._size_cache.setdefault(key, {})
        resolved_leaves = self._leaves_cache.setdefault(key, {})
        policy = RuntimeRematPolicy(plan, env)
        arena = None
        if plan.arena_plan is not None:
            arena = ArenaAllocator(plan.arena_plan,
                                   plan.arena_plan.resolve(env),
                                   hard_cap=self.arena_hard_cap)
        mm = MemoryManager(self.memory_limit, arena=arena)
        if faults is not None:
            mm.fault_hook = faults.on_memory

        def bytes_of(v: Value) -> int:
            if v.id in bound_dep:
                # tight size at the live env; bypasses the cache
                return v.nbytes_expr.evaluate(env_run)
            b = nbytes.get(v.id)
            if b is None:
                b = v.nbytes_expr.evaluate(env)
                nbytes[v.id] = b
            return b

        def call_node(node: Node, ins: Sequence[Any]) -> List[Any]:
            """Run one node on its argument tensors (``invals[:n_args]``)."""
            template, spec = self._templates[node.id]
            if node.id in self._bound_dep_nodes:
                leaves = resolve_leaves(template, env_run)
            else:
                leaves = resolved_leaves.get(node.id)
                if leaves is None:
                    leaves = resolve_leaves(template, env)
                    resolved_leaves[node.id] = leaves
            leaves = list(leaves)
            for li, x in enumerate(template):
                if isinstance(x, Arg):
                    leaves[li] = ins[x.i]
            out = call_op(node.prim, spec, leaves)
            return list(out) if node.params["multi"] else [out]

        def body_call(body) -> Any:
            """``call(node, args)`` for a loop body's nodes (arguments
            resolved once per env, kept in the per-env cache)."""
            templates = {bn.id: override_template(bn, None)
                         for bn in body.graph.nodes}
            cache = self._leaves_cache.setdefault(
                (body.graph.uid,) + key, {})

            def call(bn: Node, bins: List[Any]) -> List[Any]:
                template, spec = templates[bn.id]
                leaves = cache.get(bn.id)
                if leaves is None:
                    leaves = resolve_leaves(template, env)
                    cache[bn.id] = leaves
                leaves = list(leaves)
                for li, x in enumerate(template):
                    if isinstance(x, Arg):
                        leaves[li] = bins[x.i]
                out = call_op(bn.prim, spec, leaves)
                return list(out) if bn.params["multi"] else [out]
            return call

        storage: Dict[int, Any] = {}          # vid -> device tensor
        host_storage: Dict[int, Any] = {}     # vid -> (host copy, device)
        evicted_recompute: set = set()        # vids dropped, regenerable
        dropped_views: set = set()            # live views of evicted roots
        remaining = dict(self._remaining_template)
        holds: Dict[int, int] = {}            # regen source pins
        state = {"step": 0, "pinned": frozenset()}

        def is_materializable(vid: int) -> bool:
            return vid in storage or vid in host_storage \
                or vid in evicted_recompute or vid in dropped_views

        def maybe_free(vid: int) -> None:
            if remaining.get(vid, 0) == 0 and holds.get(vid, 0) == 0 \
                    and vid not in self._output_ids:
                v = self._value_by_id[vid]
                if v.is_materialized_input() and not self.donate_inputs:
                    return
                was_tracked = is_materializable(vid)
                storage.pop(vid, None)
                host_storage.pop(vid, None)
                evicted_recompute.discard(vid)
                dropped_views.discard(vid)
                if was_tracked and (self.count_inputs
                                    or not v.is_materialized_input()):
                    mm.free(vid)
                elif was_tracked:
                    # uncounted donated input: still release its arena slot
                    mm.arena_release(vid)

        # -- eviction callback wired into the memory manager ------------------
        def evict(need: int) -> int:
            live = {vid: mm.device_bytes(vid) for vid in list(storage)
                    if vid in plan.candidates
                    and (remaining.get(vid, 0) > 0 or holds.get(vid, 0) > 0)}
            decisions = policy.choose_victims(need, live, state["pinned"],
                                              state["step"])
            freed = 0
            for dec in decisions:
                arr = storage.pop(dec.vid, None)
                if arr is None:
                    continue
                for wid in self._views_of.get(dec.vid, ()):
                    if storage.pop(wid, None) is not None:
                        dropped_views.add(wid)
                method = dec.method
                rp = plan.candidates[dec.vid].recompute
                if method == "recompute":
                    # recompute is only safe if every source is materializable
                    if rp is None or not all(is_materializable(s)
                                             for s in rp.source_ids):
                        method = "offload"
                        mm.stats.recompute_fallbacks += 1
                if method == "offload":
                    host_storage[dec.vid] = (offload(arr), arr.device)
                    mm.evict_to_host(dec.vid)
                else:
                    for sid in rp.source_ids:
                        holds[sid] = holds.get(sid, 0) + 1
                    evicted_recompute.add(dec.vid)
                    mm.evict_drop(dec.vid)
                del arr
                freed += dec.bytes_freed
            return freed

        mm.evict_callback = evict

        # -- registration of inputs & consts ---------------------------------
        # caller-provided buffers occupy external arena slots (registered
        # before mm.alloc so the arena does not treat them as fresh allocs)
        for i, val in enumerate(g.inputs):
            storage[val.id] = take(flat_args, i, self.donate_inputs)
            if arena is not None:
                arena.place_external(val.id, bytes_of(val))
            if self.count_inputs:
                mm.alloc(val.id, bytes_of(val))
        for val in g.consts:
            storage[val.id] = val.const_val
            if arena is not None:
                arena.place_external(val.id, bytes_of(val))
            if self.count_inputs:
                mm.alloc(val.id, bytes_of(val))

        # -- materialize-on-demand (Remat::RegenerateOp) -----------------------
        def value_arg(x: Value) -> Any:
            """A value's tensor for an op argument; a dead view in a rebuilt
            view's chain is rebuilt without being stored."""
            arr = storage.get(x.id)
            if arr is not None:
                return arr
            if x.base is not None and x.id not in dropped_views:
                return rebuild_view(x)
            return materialize(x)

        def rebuild_view(v: Value) -> Any:
            node = v.producer
            outs = call_node(node, [value_arg(x)
                                    for x in node.invals[:node.n_args]])
            return outs[v.out_index]

        def materialize(v: Value) -> Any:
            arr = storage.get(v.id)
            if arr is not None:
                return arr
            if v.id in dropped_views:
                arr = rebuild_view(v)
                dropped_views.discard(v.id)
                storage[v.id] = arr
                return arr
            if v.id in host_storage:  # reload path (H2D)
                mm.ensure(bytes_of(v))
                host, device = host_storage.pop(v.id)
                arr = reload(host, device)
                del host
                mm.reload(v.id)
                storage[v.id] = arr
                return arr
            if v.id in evicted_recompute:  # recompute path
                rp = plan.candidates[v.id].recompute
                evicted_recompute.discard(v.id)
                for sid in rp.source_ids:  # recursion strictly moves up-graph
                    materialize(self._value_by_id[sid])
                outer = state["pinned"]
                state["pinned"] = outer | set(rp.source_ids)
                temps: Dict[int, Any] = {}
                held = 0
                for nid in rp.node_ids:
                    node = plan.node_by_id[nid]
                    nb = sum(bytes_of(ov) for ov in node.outvals)
                    mm.ensure(nb)
                    mm.hold(nb)
                    held += nb
                    outs = call_node(node, [
                        temps[x.id] if x.id in temps else value_arg(x)
                        for x in node.invals[:node.n_args]])
                    for ov, oa in zip(node.outvals, outs):
                        temps[ov.id] = oa
                    del outs
                arr = temps.pop(v.id)
                del temps
                state["pinned"] = outer
                mm.release(held)
                mm.restore(v.id, bytes_of(v))
                mm.stats.recompute_flops += max(1, rp.flops.evaluate(env))
                storage[v.id] = arr
                # release regen holds on sources
                for sid in rp.source_ids:
                    holds[sid] = holds.get(sid, 0) - 1
                    if holds[sid] <= 0:
                        holds.pop(sid, None)
                        maybe_free(sid)
                return arr
            raise KeyError(f"value {v} is not materializable")

        # -- main loop ----------------------------------------------------------
        hook = self.timeline_hook
        try:
            for i, node in enumerate(plan.order):
                state["step"] = i
                state["pinned"] = frozenset(
                    [iv.id for iv in node.invals]
                    + [ov.id for ov in node.outvals])
                if faults is not None:
                    faults.before_compute()
                ins = [materialize(iv) for iv in node.invals[:node.n_args]]
                for iv in node.invals[node.n_args:]:
                    materialize(iv)
                kept = [ov for ov in node.outvals
                        if ov.consumers or ov.id in self._output_ids]
                body = loop_body_of(node)
                if body is not None:
                    # rolled loop: one ensure for the loop's whole internal
                    # peak (Remat::EvictOp hoisted out of the body), then
                    # the shared account() event replay drives the
                    # MemoryManager — the same engine the VM and the
                    # resolve-time stats replay use
                    lp = body.plan(plan.shape_graph)
                    trip = body.length_expr.evaluate(env)
                    kept_flags = [ov in kept for ov in node.outvals]
                    nk = body.num_carry
                    outer_y = [(ov.id, bytes_of(ov)) for ov, k in
                               zip(node.outvals[nk:], kept_flags[nk:]) if k]
                    outer_carry = [(ov.id, bytes_of(ov)) if k else None
                                   for ov, k in zip(node.outvals[:nk],
                                                    kept_flags[:nk])]
                    mm.ensure(lp.peak_expr_for(node, kept_flags,
                                               trip).evaluate(env))
                    lp.account(mm, node.id, trip,
                               lambda bvid: lp.sizes[bvid].evaluate(env),
                               outer_y, outer_carry)
                    outs = lp.execute(ins, trip, env, body_call(body))
                    del ins
                    for ov in kept:   # account() already allocated them
                        storage[ov.id] = outs[ov.out_index]
                    del outs
                else:
                    mm.ensure(sum(bytes_of(ov) for ov in kept))  # EvictOp
                    outs = call_node(node, ins)
                    del ins
                    intro = g.bound_intros.get(node.id)
                    if intro is not None:
                        # the BindDim step: measure, clamp to the cap at the
                        # live env, publish — the kept-output allocs below
                        # then see the tight size through bytes_of
                        measured = int(outs[intro.count_out])
                        measured = min(max(measured, 0),
                                       int(intro.cap.evaluate(env_run)))
                        env_run[intro.name] = measured
                        mm.stats.measured_dims[intro.name] = measured
                    for ov in kept:
                        storage[ov.id] = outs[ov.out_index]
                        mm.alloc(ov.id, bytes_of(ov))
                    del outs
                # free dead values (buffer lifetime = last consumer)
                seen = set()
                for iv in node.invals:
                    if iv.id in seen:
                        continue
                    seen.add(iv.id)
                    remaining[iv.id] -= sum(1 for x in node.invals
                                            if x.id == iv.id)
                    maybe_free(iv.id)
                if hook is not None:
                    hook(i, node, mm)

            outputs = [materialize(v) for v in g.outputs]
            if arena is not None:
                arena.write_stats(mm.stats)
        finally:
            # the closures above form reference cycles over the storage:
            # empty it on every exit, a raise included, or the call's
            # tensors stay allocated until a garbage collection
            storage.clear()
            host_storage.clear()
            mm.evict_callback = None
        wall = time.perf_counter() - t0
        # bound graphs report the live env (measured extents, not caps)
        return outputs, RunReport(stats=mm.stats, wall_s=wall,
                                  env=env_run if g.bound_dims else env_decl)
