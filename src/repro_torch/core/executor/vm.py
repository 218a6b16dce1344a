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

A ``Loop`` runs the lowered body sub-Program per iteration on the same
fast stream (bodies have no evict path): the stacked ``ys`` are allocated
on entry and each iteration's ``y`` is copied into its row, and the body
takes its carries over (its inputs are donated), so the previous
generation is released at its last use — the memory the loop plan
accounts.  On the dynamic stream the evict check is hoisted: one
``ensure`` of the loop's exact internal peak before it runs.

A ``BindDim`` (bounded dims) reads the introducer's count — one
device-to-host sync, timed in ``RunReport.bind_dim_s`` — and publishes
it into per-call overlays of the env, the register sizes and the op
arguments: the introducer returned its payload tight, so every later op
runs on tight tensors with arguments resolved at the measured extent.
The fast stream's stats are then the resolve replay at the measured
extents, which is the dynamic stream's accounting of the same run.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from ..ir.capture import check_declared_ranges, resolve_leaves, solve_env
from ..ir.loop import stacked_outputs
from ..lowering.program import (OP_BIND_ARG, OP_BIND_DIM, OP_COMPUTE,
                                OP_DONATE, OP_FREE_SLOT, OP_LOOP,
                                OP_MAYBE_EVICT, OP_REGEN, Program,
                                ResolvedProgram)
from ..memplan.arena import ArenaAllocator
from ..remat.runtime import RuntimeRematPolicy
from .memory import MemoryManager, MemoryStats


@dataclass
class RunReport:
    stats: MemoryStats
    wall_s: float
    env: Dict[str, int] = field(default_factory=dict)
    # host seconds the BindDim steps spent reading their counts (each a
    # device-to-host sync); 0 without bounded dims
    bind_dim_s: float = 0.0


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


class _BoundRun:
    """Per-call overlays of a bounded program: the live env, register sizes
    and op arguments, rebound by each ``BindDim``."""

    def __init__(self, prog: Program, resolved: ResolvedProgram):
        self.prog = prog
        self.env = dict(resolved.env)
        self.nbytes = list(resolved.nbytes)
        self.leaves = list(resolved.leaves)
        self.measured: Dict[str, int] = {}
        self.sync_s = 0.0

    def bind(self, inst, storage: List[Any]) -> int:
        """Measure, clamp to the cap at the live env, and publish."""
        t0 = time.perf_counter()
        measured = int(storage[inst.count_reg])
        self.sync_s += time.perf_counter() - t0
        measured = min(max(measured, 0),
                       int(inst.cap_expr.evaluate(self.env)))
        if inst.payload_reg >= 0:
            got = storage[inst.payload_reg].shape[inst.axis]
            if got != measured:
                raise RuntimeError(
                    f"bounded dim {inst.name}: the payload has {got} rows "
                    f"on dim {inst.axis}, its count says {measured}")
        prog = self.prog
        self.env[inst.name] = measured
        self.measured[inst.name] = measured
        exprs = prog.nbytes_exprs
        for r in prog.bound_dep_regs[inst.name]:
            self.nbytes[r] = exprs[r].evaluate(self.env)
        for c in prog.bound_dep_cidx[inst.name]:
            self.leaves[c] = resolve_leaves(prog.computes[c].template,
                                            self.env)
        if inst.drop_count:
            storage[inst.count_reg] = None
        return measured


def run_fast(prog: Program, flat_args: List[Any], resolved: ResolvedProgram,
             bound: Optional[_BoundRun] = None) -> List[Any]:
    """The fast stream: call ops, null dead registers (see module doc)."""
    storage: List[Any] = [None] * prog.n_regs
    all_leaves = bound.leaves if bound is not None else resolved.leaves
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
                for oi, r in inst.extra_store:
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
        elif op == OP_LOOP:
            outs = exec_loop(prog.loops[inst.lidx],
                             resolved.loops[inst.lidx],
                             [storage[r] for r in inst.in_regs],
                             resolved.env)
            for oi, r in inst.store:
                storage[r] = outs[oi]
            del outs
        elif op == OP_BIND_DIM:
            bound.bind(inst, storage)
    return [storage[r] for r in prog.out_regs]


def exec_loop(info, rl, ins: List[Any], env: Dict[str, int]) -> List[Any]:
    """Run one rolled loop: the lowered body sub-Program per iteration on
    the fast stream, registers rebound (carries from the previous
    iteration's outputs, ``xs`` slices by index).  Takes ``ins`` over.

    Pure execution — memory accounting happens through the shared
    ``LoopPlanInfo.account`` engine.  The body runs the same nodes in the
    same order with the same arguments as the interpreter's op-by-op loop,
    so outputs are bitwise-identical."""
    body, lp = info.body, info.lp
    bprog, rbody = info.body_program, rl.rbody
    nc, nk = body.num_consts, body.num_carry
    consts = ins[:nc]
    carries = ins[nc:nc + nk]
    xs = [x.unbind(0) if lp.x_used[j] else None
          for j, x in enumerate(ins[nc + nk:])]
    ins.clear()
    ys = stacked_outputs(lp.y_out, rl.trip, env, carries[0].device)
    for i in range(rl.trip):
        flat = consts + carries + [x[i] if x is not None else None
                                   for x in xs]
        # the body takes the carries over: its donated input registers
        # are the only references, dropped at their last use
        carries = None
        outs = run_fast(bprog, flat, rbody)
        del flat
        carries = outs[:nk]
        for y, t in zip(ys, outs[nk:]):
            y[i].copy_(t)
        del outs
    return carries + ys


class ProgramVM:
    """Executes a lowered Program; drop-in for ``PlanInterpreter.run``."""

    def __init__(self, program: Program):
        self.program = program
        self.plan = program.plan
        # optional live-occupancy probe, dynamic (eviction) stream only:
        # called as hook(idx, inst, mm) after every executed instruction.
        # The fast stream is never instrumented — its occupancy curve is
        # exactly reconstructible off the hot path (obs.timeline)
        self.timeline_hook = None

    def run(self, flat_args: List[Any],
            env: Optional[Dict[str, int]] = None
            ) -> Tuple[List[Any], RunReport]:
        t0 = time.perf_counter()
        prog = self.program
        if env is None:
            env = solve_env(prog.graph, flat_args)
            check_declared_ranges(prog.plan.shape_graph, env)
        resolved = prog.resolve(env)
        bound = _BoundRun(prog, resolved) if prog.has_bound_dims else None
        if resolved.fast_ok:
            outs = run_fast(prog, flat_args, resolved, bound)
            stats = prog.stats_for(
                resolved, bound.measured if bound is not None else None)
        else:
            outs, stats = self._run_dynamic(flat_args, resolved, bound)
        report = RunReport(stats=stats, wall_s=0.0, env=env)
        if bound is not None:
            # surface the measured (not cap) bound dims in the report env
            report.env = {**resolved.env, **bound.measured}
            report.bind_dim_s = bound.sync_s
        report.wall_s = time.perf_counter() - t0
        return outs, report

    # --------------------------------------------------------- dynamic path
    def _run_dynamic(self, flat_args: Sequence[Any],
                     resolved: ResolvedProgram,
                     bound: Optional[_BoundRun] = None
                     ) -> Tuple[List[Any], MemoryStats]:
        prog = self.program
        plan = prog.plan
        vid_of = prog.vid_of
        reg_of = prog.reg_of
        # bounded dims: the per-call overlays (measured sizes and arguments
        # never leak into the shared resolve, which holds the caps)
        nbytes = bound.nbytes if bound is not None else resolved.nbytes
        all_leaves = bound.leaves if bound is not None else resolved.leaves
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
        hook = self.timeline_hook
        for idx, inst in enumerate(prog.instructions):
            op = inst.op
            if op == OP_COMPUTE:
                leaves = list(all_leaves[inst.cidx])
                for li, k in inst.arg_slots:
                    leaves[li] = arg(inst.in_regs[k])
                out = call_op(inst.prim, inst.spec, leaves)
                del leaves
                if inst.multi:
                    # an introducer's payload alloc waits for its BindDim
                    # (tight size); an unconsumed count reaches its
                    # register unaccounted
                    for oi, r in inst.store:
                        storage[r] = out[oi]
                        if r not in inst.defer_regs:
                            mm.alloc(vid_of[r], nbytes[r])
                    for oi, r in inst.extra_store:
                        storage[r] = out[oi]
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
                if bound is not None:
                    # the resolved ensure table holds cap sizes; sum the
                    # live overlay so pressure checks see measured sizes
                    comp = prog.computes[inst.cidx]
                    mm.ensure(sum(nbytes[r] for _oi, r in comp.store))
                else:
                    mm.ensure(resolved.ensure_bytes[inst.cidx])
            elif op == OP_BIND_DIM:
                # measure, clamp, publish, refresh the bound-dependent
                # sizes and arguments, then the deferred payload alloc at
                # the tight size
                mm.stats.measured_dims[inst.name] = bound.bind(inst, storage)
                for _oi, r in inst.alloc_store:
                    mm.alloc(vid_of[r], nbytes[r])
            elif op == OP_LOOP:
                # the evict check is hoisted — one ensure() for the loop's
                # exact internal peak — then the shared account() engine
                # drives the MemoryManager while the body runs
                state["step"] = inst.step
                state["pinned"] = inst.pinned
                ins = [arg(r) for r in inst.in_regs]
                rl = resolved.loops[inst.lidx]
                info = prog.loops[inst.lidx]
                mm.ensure(rl.extra_bytes)
                info.lp.account(mm, info.node.id, rl.trip,
                                rl.sizes.__getitem__, rl.outer_y,
                                rl.outer_carry)
                out = exec_loop(info, rl, ins, resolved.env)
                for oi, r in inst.store:   # account() allocated them
                    storage[r] = out[oi]
                del out
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
            if hook is not None:
                hook(idx, inst, mm)
        if arena is not None:
            arena.write_stats(mm.stats)
        # the closures above form reference cycles over the register file:
        # empty it, or the call's tensors (the outputs too) stay allocated
        # after the caller drops them, until a garbage collection
        storage.clear()
        host_storage.clear()
        mm.evict_callback = None
        return outputs, mm.stats
