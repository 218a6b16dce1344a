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

from ..ir.capture import (Arg, check_declared_ranges, resolve_leaves,
                          solve_env)
from ..ir.graph import Node, Value
from ..memplan.arena import ArenaAllocator
from ..remat.planner import ExecutionPlan
from ..remat.runtime import RuntimeRematPolicy
from .memory import MemoryManager
from .vm import RunReport, call_op, offload, reload, take


class PlanInterpreter:
    def __init__(self, plan: ExecutionPlan, *,
                 memory_limit: Optional[int] = None,
                 donate_inputs: bool = False,
                 count_inputs: bool = True):
        self.plan = plan
        self.g = plan.graph
        self.memory_limit = memory_limit
        self.donate_inputs = donate_inputs
        self.count_inputs = count_inputs
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
        # per-env caches reused across calls (training repeats shapes)
        self._size_cache: Dict[Tuple, Dict[int, int]] = {}
        self._leaves_cache: Dict[Tuple, Dict[int, List[Any]]] = {}

    # ---------------------------------------------------------------- run --
    def run(self, flat_args: List[Any],
            env: Optional[Dict[str, int]] = None
            ) -> Tuple[List[Any], RunReport]:
        t0 = time.perf_counter()
        g, plan = self.g, self.plan
        if env is None:
            env = solve_env(g, flat_args)
            check_declared_ranges(plan.shape_graph, env)
        key = tuple(sorted(env.items()))
        if len(self._size_cache) > 64:  # bound the per-shape caches
            self._size_cache.clear()
            self._leaves_cache.clear()
        nbytes = self._size_cache.setdefault(key, {})
        resolved_leaves = self._leaves_cache.setdefault(key, {})
        policy = RuntimeRematPolicy(plan, env)
        arena = None
        if plan.arena_plan is not None:
            arena = ArenaAllocator(plan.arena_plan,
                                   plan.arena_plan.resolve(env))
        mm = MemoryManager(self.memory_limit, arena=arena)

        def bytes_of(v: Value) -> int:
            b = nbytes.get(v.id)
            if b is None:
                b = v.nbytes_expr.evaluate(env)
                nbytes[v.id] = b
            return b

        def call_node(node: Node, ins: Sequence[Any]) -> List[Any]:
            """Run one node on its argument tensors (``invals[:n_args]``)."""
            template = node.params["leaves"]
            leaves = resolved_leaves.get(node.id)
            if leaves is None:
                leaves = resolve_leaves(template, env)
                resolved_leaves[node.id] = leaves
            leaves = list(leaves)
            for li, x in enumerate(template):
                if isinstance(x, Arg):
                    leaves[li] = ins[x.i]
            out = call_op(node.prim, node.params["spec"], leaves)
            return list(out) if node.params["multi"] else [out]

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
        for i, node in enumerate(plan.order):
            state["step"] = i
            state["pinned"] = frozenset(
                [iv.id for iv in node.invals] + [ov.id for ov in node.outvals])
            ins = [materialize(iv) for iv in node.invals[:node.n_args]]
            for iv in node.invals[node.n_args:]:
                materialize(iv)
            kept = [ov for ov in node.outvals
                    if ov.consumers or ov.id in self._output_ids]
            mm.ensure(sum(bytes_of(ov) for ov in kept))  # Remat::EvictOp
            outs = call_node(node, ins)
            del ins
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
                remaining[iv.id] -= sum(1 for x in node.invals if x.id == iv.id)
                maybe_free(iv.id)

        outputs = [materialize(v) for v in g.outputs]
        if arena is not None:
            arena.write_stats(mm.stats)
        wall = time.perf_counter() - t0
        return outputs, RunReport(stats=mm.stats, wall_s=wall, env=env)
