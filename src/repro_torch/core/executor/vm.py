"""Slim register VM over a lowered :class:`~repro_torch.core.lowering.Program`.

The default executor.  Two regimes, chosen per dim binding by
``Program.resolve``:

* **fast stream** — when no ``MaybeEvict`` can fire at this env (no
  memory limit, or the replayed peak fits under it), the hot loop is
  exactly: gather input registers, call the op, store outputs, null dead
  registers.  Dropping a dead register's reference is the free: PyTorch's
  caching allocator takes the storage back once nothing aliases it.  The
  call's complete ``MemoryStats`` was precomputed by the resolve replay.
* **dynamic stream** — under real memory pressure the full instruction
  stream runs: ``MaybeEvict`` triggers the runtime remat policy at the
  op boundaries the lowering marked, ``Regen`` rematerializes evicted
  registers through reload or the candidate's lowered sub-program, and
  frees honor regeneration holds.  Outputs are bitwise-identical to the
  fast stream and to the reference ``PlanInterpreter``.

An evicted tensor is really released: its register, and every view
register of it (a view holds its root's storage), drop their references.
Offload copies it into pinned host memory with ``non_blocking=True`` on
the current stream, the stream the ops run on, so the device block is
reused only by work queued after the copy; reload copies it back the
same way (PyTorch's pinned-memory allocator records an event on each
copy and reuses a pinned block only after it has completed).
A dropped view is rebuilt, when read, by re-running its view op over the
regenerated root.  A recompute sub-program's temporaries are counted
while it runs.

Under ``donate_inputs`` the VM takes each input out of ``flat_args`` as
it binds it, so its register is the executor's only reference and the
``Donate`` at the input's death point releases it (if the caller holds
none: ``DynamicShapeFunction.call_donated``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from ..ir.capture import check_declared_ranges, solve_env
from ..lowering.program import (OP_BIND_ARG, OP_COMPUTE, OP_DONATE,
                                OP_FREE_SLOT, OP_MAYBE_EVICT, OP_REGEN,
                                Program, ResolvedProgram)
from ..memplan.arena import ArenaAllocator
from ..remat.runtime import RuntimeRematPolicy
from .memory import MemoryManager, MemoryStats


@dataclass
class RunReport:
    stats: MemoryStats
    wall_s: float
    env: Dict[str, int] = field(default_factory=dict)


def call_op(prim: Any, spec: Any, leaves: List[Any]) -> Any:
    """Call ``prim`` with the arguments ``spec`` unflattens from
    ``leaves``; the caller's ``leaves`` list is the only reference kept."""
    args, kwargs = pytree.tree_unflatten(leaves, spec)
    return prim(*args, **kwargs)


def offload(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` with its strides: pinned and queued without
    waiting when ``t`` is on a CUDA device."""
    cuda = t.device.type == "cuda"
    host = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                               pin_memory=cuda)
    return host.copy_(t, non_blocking=cuda)


def reload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``host`` copied back to ``device`` with its strides (queued without
    waiting on a CUDA device)."""
    t = torch.empty_strided(host.size(), host.stride(), dtype=host.dtype,
                            device=device)
    return t.copy_(host, non_blocking=device.type == "cuda")


def take(flat_args: List[Any], index: int, donate: bool) -> Any:
    """Flat input ``index``; taken out of the list when it is donated."""
    x = flat_args[index]
    if donate:
        flat_args[index] = None
    return x


class ProgramVM:
    """Executes a lowered Program; drop-in for ``PlanInterpreter.run``."""

    def __init__(self, program: Program):
        self.program = program
        self.plan = program.plan

    def run(self, flat_args: List[Any],
            env: Optional[Dict[str, int]] = None
            ) -> Tuple[List[Any], RunReport]:
        t0 = time.perf_counter()
        prog = self.program
        if env is None:
            env = solve_env(prog.graph, flat_args)
            check_declared_ranges(prog.plan.shape_graph, env)
        resolved = prog.resolve(env)
        if resolved.fast_ok:
            outs = self._run_fast(flat_args, resolved)
            stats = prog.stats_for(resolved)
        else:
            outs, stats = self._run_dynamic(flat_args, resolved)
        wall = time.perf_counter() - t0
        return outs, RunReport(stats=stats, wall_s=wall, env=env)

    # ------------------------------------------------------------ fast path
    def _run_fast(self, flat_args: Sequence[Any],
                  resolved: ResolvedProgram) -> List[Any]:
        prog = self.program
        storage: List[Any] = [None] * prog.n_regs
        all_leaves = resolved.leaves
        unflatten = pytree.tree_unflatten
        for inst in prog.fast_instructions:
            op = inst.op
            if op == OP_COMPUTE:
                leaves = list(all_leaves[inst.cidx])
                in_regs = inst.in_regs
                for li, k in inst.arg_slots:
                    leaves[li] = storage[in_regs[k]]
                args, kwargs = unflatten(leaves, inst.spec)
                out = inst.prim(*args, **kwargs)
                del leaves, args, kwargs
                if inst.multi:
                    for oi, r in inst.store:
                        storage[r] = out[oi]
                else:
                    for _oi, r in inst.store:
                        storage[r] = out
                del out
            elif op == OP_BIND_ARG:
                storage[inst.reg] = (
                    take(flat_args, inst.index, prog.donate_inputs)
                    if inst.index >= 0 else inst.const)
            elif op == OP_FREE_SLOT or op == OP_DONATE:
                storage[inst.reg] = None
        return [storage[r] for r in prog.out_regs]

    # --------------------------------------------------------- dynamic path
    def _run_dynamic(self, flat_args: Sequence[Any],
                     resolved: ResolvedProgram
                     ) -> Tuple[List[Any], MemoryStats]:
        prog = self.program
        plan = prog.plan
        vid_of = prog.vid_of
        reg_of = prog.reg_of
        nbytes = resolved.nbytes
        all_leaves = resolved.leaves
        death = prog.death_step
        view_src = prog.view_src

        policy = RuntimeRematPolicy(plan, resolved.env)
        arena = None
        if resolved.arena is not None:
            arena = ArenaAllocator(plan.arena_plan, resolved.arena)
        mm = MemoryManager(prog.memory_limit, arena=arena)

        storage: List[Any] = [None] * prog.n_regs
        host_storage: Dict[int, Tuple[torch.Tensor, torch.device]] = {}
        evicted_recompute: set = set()        # regs dropped, regenerable
        dropped_views: set = set()            # live views of evicted roots
        holds: Dict[int, int] = {}            # regen source pins
        pending_free: Dict[int, bool] = {}    # dead-but-held: reg -> counted
        state = {"step": 0, "pinned": frozenset()}

        def is_materializable(reg: int) -> bool:
            return storage[reg] is not None or reg in host_storage \
                or reg in evicted_recompute or reg in dropped_views

        def free_reg(reg: int, counted: bool) -> None:
            was_tracked = is_materializable(reg)
            storage[reg] = None
            host_storage.pop(reg, None)
            evicted_recompute.discard(reg)
            dropped_views.discard(reg)
            if not was_tracked:
                return
            if counted:
                mm.free(vid_of[reg])
            else:
                # uncounted donated input: still release its arena slot
                mm.arena_release(vid_of[reg])

        # -- eviction callback (the folded RuntimeRematPolicy check) ---------
        def evict(need: int) -> int:
            live: Dict[int, int] = {}
            for reg in prog.candidate_regs:
                if storage[reg] is None:
                    continue
                if death[reg] >= state["step"] or holds.get(reg, 0) > 0:
                    live[vid_of[reg]] = mm.device_bytes(vid_of[reg])
            decisions = policy.choose_victims(need, live, state["pinned"],
                                              state["step"])
            freed = 0
            for dec in decisions:
                reg = reg_of[dec.vid]
                t = storage[reg]
                if t is None:
                    continue
                storage[reg] = None
                for vr in prog.views_of.get(reg, ()):
                    if storage[vr] is not None:
                        storage[vr] = None
                        dropped_views.add(vr)
                method = dec.method
                sub = prog.regen.get(reg)
                if method == "recompute":
                    # recompute is only safe if every source is materializable
                    if sub is None or not all(is_materializable(s)
                                              for s in sub.source_regs):
                        method = "offload"
                        mm.stats.recompute_fallbacks += 1
                if method == "offload":
                    host_storage[reg] = (offload(t), t.device)
                    mm.evict_to_host(dec.vid)
                else:
                    for s in sub.source_regs:
                        holds[s] = holds.get(s, 0) + 1
                    evicted_recompute.add(reg)
                    mm.evict_drop(dec.vid)
                del t
                freed += dec.bytes_freed
            return freed

        mm.evict_callback = evict

        # -- materialize-on-demand (Regen instruction body) ------------------
        def arg(reg: int) -> Any:
            """A register's tensor for an op argument; a dead view in a
            rebuilt view's chain is rebuilt without being stored."""
            t = storage[reg]
            if t is not None:
                return t
            if reg in view_src and reg not in dropped_views:
                return rebuild_view(reg)
            return materialize(reg)

        def rebuild_view(reg: int) -> Any:
            comp, oi = view_src[reg]
            leaves = list(all_leaves[comp.cidx])
            for li, k in comp.arg_slots:
                leaves[li] = arg(comp.in_regs[k])
            out = call_op(comp.prim, comp.spec, leaves)
            return out[oi] if comp.multi else out

        def materialize(reg: int) -> Any:
            t = storage[reg]
            if t is not None:
                return t
            vid = vid_of[reg]
            if reg in dropped_views:
                t = rebuild_view(reg)
                dropped_views.discard(reg)
                storage[reg] = t
                return t
            if reg in host_storage:  # reload path (H2D)
                mm.ensure(nbytes[reg])
                host, device = host_storage.pop(reg)
                t = reload(host, device)
                del host
                mm.reload(vid)
                storage[reg] = t
                return t
            if reg in evicted_recompute:  # recompute sub-program
                sub = prog.regen[reg]
                evicted_recompute.discard(reg)
                for s in sub.source_regs:  # recursion strictly moves up-graph
                    materialize(s)
                # the sources stay on the device while the steps read them
                outer = state["pinned"]
                state["pinned"] = outer | {vid_of[s] for s in sub.source_regs}
                temps: List[Any] = [None] * sub.n_temps
                held = 0
                for st, nb in zip(sub.steps, resolved.regen_step_bytes[reg]):
                    mm.ensure(nb)
                    mm.hold(nb)
                    held += nb
                    leaves = list(all_leaves[st.cidx])
                    for li, k in st.arg_slots:
                        is_temp, idx = st.in_refs[k]
                        leaves[li] = temps[idx] if is_temp else arg(idx)
                    out = call_op(st.prim, st.spec, leaves)
                    del leaves
                    if st.multi:
                        for oi, ti in st.writes:
                            temps[ti] = out[oi]
                    else:
                        for _oi, ti in st.writes:
                            temps[ti] = out
                    del out
                t = temps[sub.target_temp]
                del temps
                state["pinned"] = outer
                mm.release(held)
                mm.restore(vid, nbytes[reg])
                mm.stats.recompute_flops += resolved.regen_flops[reg]
                storage[reg] = t
                # release regen holds on sources
                for s in sub.source_regs:
                    holds[s] = holds.get(s, 0) - 1
                    if holds[s] <= 0:
                        holds.pop(s, None)
                        counted = pending_free.pop(s, None)
                        if counted is not None:
                            free_reg(s, counted)
                return t
            raise KeyError(f"value {vid} is not materializable")

        # -- instruction loop -------------------------------------------------
        outputs: List[Any] = []
        for inst in prog.instructions:
            op = inst.op
            if op == OP_COMPUTE:
                leaves = list(all_leaves[inst.cidx])
                for li, k in inst.arg_slots:
                    leaves[li] = arg(inst.in_regs[k])
                out = call_op(inst.prim, inst.spec, leaves)
                del leaves
                if inst.multi:
                    for oi, r in inst.store:
                        storage[r] = out[oi]
                        mm.alloc(vid_of[r], nbytes[r])
                else:
                    for _oi, r in inst.store:
                        storage[r] = out
                        mm.alloc(vid_of[r], nbytes[r])
                del out
            elif op == OP_REGEN:
                state["step"] = inst.step
                state["pinned"] = inst.pinned
                for r in inst.regs:
                    materialize(r)
            elif op == OP_MAYBE_EVICT:   # Remat::EvictOp check
                state["step"] = inst.step
                state["pinned"] = inst.pinned
                mm.ensure(resolved.ensure_bytes[inst.cidx])
            elif op == OP_BIND_ARG:
                storage[inst.reg] = (
                    take(flat_args, inst.index, prog.donate_inputs)
                    if inst.index >= 0 else inst.const)
                if arena is not None:
                    arena.place_external(inst.vid, nbytes[inst.reg])
                if prog.count_inputs:
                    mm.alloc(inst.vid, nbytes[inst.reg])
            elif op == OP_FREE_SLOT:
                if holds.get(inst.reg, 0) > 0:
                    pending_free[inst.reg] = True
                else:
                    free_reg(inst.reg, True)
            elif op == OP_DONATE:
                if holds.get(inst.reg, 0) > 0:
                    pending_free[inst.reg] = inst.counted
                else:
                    free_reg(inst.reg, inst.counted)
            else:  # OP_RETURN
                outputs = [materialize(r) for r in inst.regs]
        if arena is not None:
            arena.write_stats(mm.stats)
        return outputs, mm.stats
