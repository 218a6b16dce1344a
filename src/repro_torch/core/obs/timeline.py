"""Plan-vs-actual memory timelines over a lowered ``Program``.

Port of ``repro/core/obs/timeline.py``.  Two curves, built from
*independent* sources so drift between them means something:

* **predicted** — straight from the compile-time plan: the liveness
  intervals of :mod:`repro_torch.core.memplan.liveness` evaluated at one
  env give the planned occupancy at every schedule step (at a rolled
  loop's step: what was live before it plus the loop's exact
  internal-peak delta from the shared event engine's trip models, where
  the reference adds that delta to the loop's own buffers too — see
  :func:`planned_timeline`);
* **actual** — a replay of the lowered instruction stream through a real
  ``MemoryManager`` + ``ArenaAllocator`` pair, recording device / arena
  occupancy after every instruction (the program counter).  For the
  no-eviction regime this reconstruction is *exact*: the fast stream's
  alloc/free traffic is fully determined by the env (the same fact
  ``Program.resolve`` exploits to precompute ``MemoryStats``), so the
  curve equals what a live run's sampled occupancy would show, without
  instrumenting the hot loop.  Runs under memory pressure can instead
  sample live occupancy through the executors' ``timeline_hook``.

The replay dispatches on the port's instruction classes
(:mod:`repro_torch.core.lowering.program`); ``TimelinePoint.opname`` is
the class name, the reference's names for the same instructions.

``diff_timeline`` correlates the two: peak comparison against the plan's
guaranteed ``arena_bound_bytes`` and an allocation-by-allocation audit —
every actual allocation must be *explained* by a planned liveness
interval covering its step with the same byte count (rolled-loop internal
buffers, keyed ``(nid, parity, bvid)``, are driven by the plan's own
event templates and audited against them by construction).  A non-empty
``unexplained`` list is the plan-vs-reality drift alarm.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..executor.memory import MemoryManager
from ..ir.dynamism import complete_bound_env
from ..lowering.program import (BindArg, BindDim, Compute, Donate, FreeSlot,
                                Loop, Program)
from ..memplan.arena import ArenaAllocator
from ..memplan.liveness import analyze_liveness


@dataclass(frozen=True)
class TimelinePoint:
    """Occupancy right after one instruction of the lowered stream."""

    idx: int                  # program counter (instruction index)
    step: int                 # schedule step of the governing Compute/Loop
    opname: str
    device_used: int
    arena_in_use: int


@dataclass
class Timeline:
    """One reconstructed (or sampled) occupancy curve."""

    env: Dict[str, int]
    points: List[TimelinePoint] = field(default_factory=list)
    peak_device: int = 0
    peak_arena_in_use: int = 0
    arena_bytes: int = 0          # final arena size (reserve, growth incl.)

    def __len__(self) -> int:
        return len(self.points)


class _AuditSink:
    """Forwards a rolled loop's ``account()`` traffic to the MemoryManager
    while auditing it against the loop plan's own size table."""

    def __init__(self, mm: MemoryManager, sizes_ok, unexplained: List[Dict],
                 idx: int, step: int):
        self.mm = mm
        self.sizes_ok = sizes_ok
        self.unexplained = unexplained
        self.idx = idx
        self.step = step

    def alloc(self, key, nbytes) -> None:
        self.mm.alloc(key, nbytes)
        if not self.sizes_ok(key, nbytes):
            self.unexplained.append(dict(
                kind="loop-alloc", key=repr(key), bytes=nbytes,
                idx=self.idx, step=self.step,
                why="no loop event template sizes this buffer"))

    def free(self, key) -> None:
        self.mm.free(key)


def actual_timeline(program: Program, env: Dict[str, int],
                    unexplained_out: Optional[List[Dict]] = None) -> Timeline:
    """Replay the no-eviction instruction stream, recording occupancy.

    Pure accounting — no tensors are materialized, so probing the biggest
    declared env costs microseconds.  ``unexplained_out``, when given,
    collects the allocation audit against the plan's liveness intervals
    (see :func:`diff_timeline`).

    Value-dependent bounded dims: a replay cannot measure anything, so a
    bound dim missing from ``env`` is completed to its cap — the curve is
    the "measured == cap" worst case.  Pass a measured value (e.g. from
    ``RunReport.env``) to reconstruct a specific call's tight curve."""
    resolved = program.resolve(env)
    env = resolved.env          # bound dims completed (caps unless given)
    nbytes = resolved.nbytes
    arena = None
    if resolved.arena is not None:
        arena = ArenaAllocator(program.plan.arena_plan, resolved.arena)
    mm = MemoryManager(None, arena=arena)
    vid_of = program.vid_of

    liveness = None
    loop_sizes: List[Dict[int, int]] = [rl.sizes for rl in resolved.loops]
    if unexplained_out is not None:
        ap = program.plan.arena_plan
        liveness = ap.liveness if ap is not None else analyze_liveness(
            program.plan.graph, program.plan.order,
            donate_inputs=program.donate_inputs)

    def audit(vid: int, b: int, idx: int, step: int, kind: str) -> None:
        if unexplained_out is None:
            return
        iv = liveness.get(vid)
        if iv is None:
            unexplained_out.append(dict(
                kind=kind, vid=vid, bytes=b, idx=idx, step=step,
                why="no planned liveness interval"))
        elif not (iv.start <= step <= iv.end):
            unexplained_out.append(dict(
                kind=kind, vid=vid, bytes=b, idx=idx, step=step,
                why=f"outside planned interval [{iv.start}, {iv.end}]"))
        elif iv.nbytes_expr.evaluate(env) != b:
            unexplained_out.append(dict(
                kind=kind, vid=vid, bytes=b, idx=idx, step=step,
                why=f"planned {iv.nbytes_expr.evaluate(env)} bytes, "
                    f"allocated {b}"))

    tl = Timeline(env=dict(env))
    pos = program.plan.pos
    step = -1
    for idx, inst in enumerate(program.fast_instructions):
        if isinstance(inst, Compute):
            step = pos[inst.node.id]
            for _oi, r in inst.store:
                if r in inst.defer_regs:
                    continue          # allocated by the following BindDim
                mm.alloc(vid_of[r], nbytes[r])
                audit(vid_of[r], nbytes[r], idx, step, "alloc")
        elif isinstance(inst, BindDim):
            for _oi, r in inst.alloc_store:
                mm.alloc(vid_of[r], nbytes[r])
                audit(vid_of[r], nbytes[r], idx, step, "alloc")
        elif isinstance(inst, BindArg):
            if arena is not None:
                arena.place_external(inst.vid, nbytes[inst.reg])
            if program.count_inputs:
                mm.alloc(inst.vid, nbytes[inst.reg])
                audit(inst.vid, nbytes[inst.reg], idx, -1, "bind")
        elif isinstance(inst, FreeSlot):
            mm.free(inst.vid)
        elif isinstance(inst, Donate):
            if inst.counted:
                mm.free(inst.vid)
            else:
                mm.arena_release(inst.vid)
        elif isinstance(inst, Loop):
            step = inst.step
            rl = resolved.loops[inst.lidx]
            info = program.loops[inst.lidx]
            sizes = loop_sizes[inst.lidx]

            def sizes_ok(key, b, _sizes=sizes, _nid=info.node.id) -> bool:
                if not isinstance(key, tuple):     # outer vid: liveness audit
                    return True
                nid, _par, bvid = key
                return nid == _nid and _sizes.get(bvid) == b

            sink = mm if unexplained_out is None else _AuditSink(
                mm, sizes_ok, unexplained_out, idx, step)
            info.lp.account(sink, info.node.id, rl.trip,
                            rl.sizes.__getitem__, rl.outer_y, rl.outer_carry)
            if unexplained_out is not None:
                for ov_vid, b in rl.outer_y:
                    audit(ov_vid, b, idx, step, "loop-out")
        tl.points.append(TimelinePoint(
            idx=idx, step=step, opname=type(inst).__name__,
            device_used=mm.stats.device_used,
            arena_in_use=0 if arena is None else arena.in_use_bytes))
    tl.peak_device = mm.stats.device_peak
    if arena is not None:
        tl.peak_arena_in_use = arena.peak_in_use
        tl.arena_bytes = arena.arena_bytes
    return tl


def planned_timeline(program: Program,
                     env: Dict[str, int]) -> Tuple[List[int], List[int]]:
    """Per-schedule-step planned occupancy ``(device, arena)`` from the
    liveness intervals at ``env``.

    ``device[s]`` counts every interval covering step ``s`` (externals
    included iff the program counts inputs); ``arena[s]`` only the
    arena-served values (externals and donated-slot placements ride caller
    memory).  At a rolled loop's step ``s`` the loop's internal-peak delta
    is added — the loop plan's own trip-model expression, the same number
    the executors ``ensure()`` before entering the loop — over the
    intervals that were live *before* the loop: that delta already holds
    what the loop allocates (its outer outputs and the body buffers planned
    into slots, whose intervals start at ``s``).  The reference adds it to
    every interval covering ``s``, counting those twice, so its prediction
    at a loop step exceeds the replayed peak; this one equals it."""
    plan = program.plan
    if program.graph.bound_dims:
        env = complete_bound_env(program.graph, env)
    ap = plan.arena_plan
    liveness = ap.liveness if ap is not None else analyze_liveness(
        plan.graph, plan.order, donate_inputs=program.donate_inputs)
    resolved = program.resolve(env)
    loop_extra = {inst.step: resolved.loops[inst.lidx].extra_bytes
                  for inst in program.instructions if isinstance(inst, Loop)}
    horizon = len(plan.order)
    device = [0] * (horizon + 1)
    arena = [0] * (horizon + 1)
    for vid, iv in liveness.items():
        b = iv.nbytes_expr.evaluate(env)
        counted = not (iv.external and not program.count_inputs)
        in_arena = not iv.external
        if in_arena and ap is not None:
            asg = ap.assignment.get(vid)
            if asg is not None and ap.slots[asg.sid].external:
                in_arena = False          # planned into a donated buffer
        lo, hi = max(iv.start, 0), min(iv.end, horizon)
        for s in range(lo, hi + 1):
            if s == iv.start and s in loop_extra:
                continue                  # allocated inside the loop
            if counted:
                device[s] += b
            if in_arena:
                arena[s] += b
    for s, extra in loop_extra.items():
        device[s] += extra
        arena[s] += extra
    return device, arena


@dataclass
class TimelineDiff:
    """The plan-vs-actual correlation for one env."""

    env: Dict[str, int]
    predicted_device: List[int]          # per schedule step
    predicted_arena: List[int]
    actual: Timeline
    predicted_peak_device: int = 0
    predicted_peak_arena: int = 0
    arena_bound_bytes: Optional[int] = None
    unexplained: List[Dict] = field(default_factory=list)

    @property
    def within_bound(self) -> bool:
        """Actual arena peak stayed under the plan's guaranteed bound
        (vacuously true when no bound exists — unbounded dims)."""
        if self.arena_bound_bytes is None:
            return True
        return self.actual.arena_bytes <= self.arena_bound_bytes

    @property
    def ok(self) -> bool:
        return self.within_bound and not self.unexplained

    def summary(self) -> str:
        bound = ("n/a" if self.arena_bound_bytes is None
                 else f"{self.arena_bound_bytes:,}")
        return (f"env={self.env}: actual device peak "
                f"{self.actual.peak_device:,} vs predicted "
                f"{self.predicted_peak_device:,}; arena "
                f"{self.actual.arena_bytes:,} <= bound {bound}: "
                f"{self.within_bound}; unexplained allocations: "
                f"{len(self.unexplained)}")


def diff_timeline(program: Program, env: Dict[str, int]) -> TimelineDiff:
    """Build both curves for ``env`` and audit actual against planned."""
    if program.graph.bound_dims:
        env = complete_bound_env(program.graph, env)
    unexplained: List[Dict] = []
    actual = actual_timeline(program, env, unexplained_out=unexplained)
    device, arena = planned_timeline(program, env)
    bound = None
    if program.plan.arena_plan is not None:
        bound = program.plan.arena_plan.arena_bound_bytes
    return TimelineDiff(
        env=dict(env), predicted_device=device, predicted_arena=arena,
        actual=actual,
        predicted_peak_device=max(device) if device else 0,
        predicted_peak_arena=max(arena) if arena else 0,
        arena_bound_bytes=bound, unexplained=unexplained)
