"""Symbolic buffer assignment (memory-planner stage 2).

Packs live intervals into reusable *slots* — in the style of Relax's
dynamic-shape memory planning and XLA's global-decreasing-size best-fit
heap simulator, but with symbolic sizes throughout:

* values are placed **largest worst-case size first** (the big activations
  found slots; everything smaller fills gaps), so slots are sized by their
  founding member and later members ride free;
* a slot can host ``v`` when no previous member's live interval overlaps
  ``v``'s;
* among hosting slots we first look for a **provable fit** — some slot
  size expression ``e`` with ``ShapeGraph.compare(bytes(v), e) ∈
  {LT, LE, EQ}`` (the interval fallback makes many cross-symbol cases
  decidable once dim ranges are declared).  Provable fit is *hard reuse*:
  for every env the value fits the slot as already sized;
* otherwise a slot is reused **checked**: fit holds at the worst-case env
  but cannot be proven for all envs, so the value's size expression joins
  the slot's candidate set and the runtime sizes the slot to the max over
  the set for the *actual* env — growing the slot beyond its founding size
  exactly when that env needs it (fallback slot growth);
* only when no compatible slot exists does the value open a fresh one.

Inputs/consts occupy *external* slots (caller-provided buffers, zero arena
cost).  With ``donate_inputs`` a dead input's slot joins the reuse pool —
provable fits only, a caller buffer cannot grow — so same-shaped late
values (e.g. updated params) land in donated buffers.

A slot's symbolic size is ``max`` over its candidate size expressions;
``ArenaPlan.arena_bound_bytes`` sums each slot's interval upper bound over
the declared dim ranges — a guaranteed arena size whenever every dynamic
dim is bounded above.

Per concrete env, ``ArenaPlan.resolve`` turns the symbolic plan into an
exact arena *reserve*: slot sizes evaluate to plain bytes and the planned
lifetimes are address-packed first-fit-decreasing (a vacant buffer's bytes
return to the pool between occupancies, as in an arena-backed caching
allocator), capped by Σ slot capacities so the compile-time bound always
dominates.  Slot reuse decides *buffer identity* (what the runtime
allocator services and reports); the resolve height decides *arena size*.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..ir.graph import Graph, Node
from ..symbolic import Cmp, ShapeGraph, SymbolicExpr
from .liveness import LiveInterval, analyze_liveness

# how many candidate slots a single value probes with the full symbolic
# comparison before settling for a checked reuse (exact-expression matches
# are found through a dict first and are not subject to this cap)
_MAX_FIT_PROBES = 24


@dataclass
class SlotInfo:
    """One reusable buffer of the planned arena."""

    sid: int
    external: bool                      # caller-provided (input/const buffer)
    members: List[int] = field(default_factory=list)
    # distinct candidate size expressions; the slot's size for an env is the
    # max over their evaluations (provably-fitting members add nothing)
    size_exprs: List[SymbolicExpr] = field(default_factory=list)
    # member live intervals as (start, end), kept sorted by start
    intervals: List[Tuple[int, int]] = field(default_factory=list)
    # cached bounds of the size over the declared dim ranges + its value at
    # the representative worst-case env (the packing order key)
    size_lo: Optional[int] = 0
    size_hi: Optional[int] = None
    rep_size: int = 0

    @property
    def size_expr(self) -> SymbolicExpr:
        """The slot's symbolic size, ``max`` over the candidate set."""
        out = self.size_exprs[0]
        for e in self.size_exprs[1:]:
            out = SymbolicExpr.max_of(out, e)
        return out

    def capacity(self, env: Dict[str, int]) -> int:
        return max(e.evaluate(env) for e in self.size_exprs)

    def can_host(self, start: int, end: int) -> bool:
        """True when [start, end] overlaps no member interval."""
        i = bisect.bisect_left(self.intervals, (start, -1))
        if i < len(self.intervals) and self.intervals[i][0] <= end:
            return False
        return not (i > 0 and self.intervals[i - 1][1] >= start)

    def add_member(self, vid: int, start: int, end: int) -> None:
        self.members.append(vid)
        bisect.insort(self.intervals, (start, end))


@dataclass(frozen=True)
class SlotAssignment:
    vid: int
    sid: int
    provable: bool      # fit proven at compile time (hard reuse)
    reused: bool        # slot had a previous member
    donated: bool       # landed in a freed donated input/const buffer


@dataclass
class ResolvedArena:
    """The plan realized for one concrete env (sizes are plain bytes).

    ``arena_bytes`` is the reserve the arena needs to service the plan at
    this env: the height of a first-fit-decreasing *address* packing of
    the planned value lifetimes — a vacant buffer's bytes return to the
    pool between occupancies, exactly like an arena-backed caching
    allocator.  Values planned into donated caller buffers stay out of
    the pack (their bytes are the caller's).  ``slot_cap_total`` (Σ slot
    capacities) is the no-address-reuse fallback; ``arena_bytes`` never
    exceeds it."""

    caps: List[int]            # per-slot capacity at this env
    external: List[bool]
    arena_bytes: int
    packed_height: int
    slot_cap_total: int
    # concrete per-value byte offset into the packed arena for this env
    # (arena-served values only — external/donated placements are the
    # caller's memory).  Consumed by the lowered Program's resolve():
    # offsets and sizes land in the executable artifact in one pass.
    offsets: Dict[int, int] = field(default_factory=dict)


@dataclass
class ArenaPlan:
    """Compile-time slot assignment + symbolic arena sizing."""

    slots: List[SlotInfo]
    assignment: Dict[int, SlotAssignment]    # vid -> slot
    liveness: Dict[int, LiveInterval]
    donate_inputs: bool
    horizon: int = 0               # len(order); liveness end for survivors
    n_assigned: int = 0            # arena-planned intermediates
    n_reused: int = 0
    n_provable_reuses: int = 0
    n_checked_reuses: int = 0
    n_donated_reuses: int = 0
    # guaranteed bounds on the arena size over the declared dim ranges:
    # hi = Σ per-slot interval highs (None when some live dim has no
    # declared upper bound); lo = the largest arena-served value at its
    # smallest in-range size (the packed reserve holds its biggest block)
    arena_bound_bytes: Optional[int] = None
    arena_bound_lo: int = 0

    def __post_init__(self):
        self._resolve_cache: Dict[Tuple, ResolvedArena] = {}

    @property
    def n_slots(self) -> int:
        """Arena-allocated slots (external/donated buffers excluded)."""
        return sum(1 for s in self.slots if not s.external)

    @property
    def planned_reuse_ratio(self) -> float:
        return self.n_reused / self.n_assigned if self.n_assigned else 0.0

    def slot_capacities(self, env: Dict[str, int]) -> List[int]:
        """Per-slot byte capacity for a concrete env (index = sid)."""
        return [s.capacity(env) for s in self.slots]

    def resolve(self, env: Dict[str, int]) -> ResolvedArena:
        """Realize the plan for ``env``: evaluate every slot size and carve
        whole slots into hosts whose idle bytes provably cover them at
        every step of the planned timeline (sizes are concrete here, so
        the check is exact).  Cached per env — training repeats shapes."""
        key = tuple(sorted(env.items()))
        out = self._resolve_cache.get(key)
        if out is None:
            if len(self._resolve_cache) > 64:
                self._resolve_cache.clear()
            out = _resolve_arena(self, env)
            self._resolve_cache[key] = out
        return out

    def arena_bytes(self, env: Dict[str, int]) -> int:
        """Planned arena size for ``env``: Σ capacities of the non-external
        root slots (carved slots ride inside their hosts)."""
        return self.resolve(env).arena_bytes


def _resolve_arena(plan: ArenaPlan, env: Dict[str, int]) -> ResolvedArena:
    caps = plan.slot_capacities(env)
    external = [s.external for s in plan.slots]
    slot_total = sum(c for c, ext in zip(caps, external) if not ext)

    # first-fit-decreasing address packing of the planned lifetimes; values
    # planned into donated caller buffers are served outside the arena
    vals = []
    for vid, iv in plan.liveness.items():
        if iv.external:
            continue
        asg = plan.assignment.get(vid)
        if asg is not None and plan.slots[asg.sid].external:
            continue
        vals.append((iv.start, iv.end, iv.nbytes_expr.evaluate(env), vid))
    vals.sort(key=lambda x: (-x[2], x[0]))

    placed: List[Tuple[int, int, int, int]] = []   # (start, end, size, off)
    offsets: Dict[int, int] = {}
    height = 0
    for (st, en, sz, vid) in vals:
        spans = sorted((off, off + s) for (s2, e2, s, off) in placed
                       if not (e2 < st or en < s2))
        off = 0
        for (lo, hi) in spans:
            if off + sz <= lo:
                break
            off = max(off, hi)
        placed.append((st, en, sz, off))
        offsets[vid] = off
        height = max(height, off + sz)

    return ResolvedArena(caps=caps, external=external,
                         arena_bytes=min(height, slot_total),
                         packed_height=height, slot_cap_total=slot_total,
                         offsets=offsets)


def _representative_env(graph: Graph, sg: ShapeGraph) -> Dict[str, int]:
    """Worst-case-leaning env used only to order values for packing:
    every dim at its declared upper bound, defaulting to 64."""
    env = {}
    for name in graph.free_symbols():
        iv = sg.declared_ranges.get(name)
        v = 64 if iv is None or iv.hi is None else iv.hi
        if iv is not None and iv.lo is not None:
            v = max(v, iv.lo)
        env[name] = v
    return env


def build_arena_plan(graph: Graph, order: Sequence[Node],
                     shape_graph: Optional[ShapeGraph] = None, *,
                     donate_inputs: bool = False) -> ArenaPlan:
    sg = shape_graph if shape_graph is not None else ShapeGraph()
    liveness = analyze_liveness(graph, order, donate_inputs=donate_inputs)
    rep_env = _representative_env(graph, sg)
    # many values share interned size exprs: evaluate each once per compile
    _rep_memo: Dict[int, int] = {}

    def rep_eval(e) -> int:
        v = _rep_memo.get(e.uid)
        if v is None:
            v = e.evaluate(rep_env)
            _rep_memo[e.uid] = v
        return v

    slots: List[SlotInfo] = []
    assignment: Dict[int, SlotAssignment] = {}
    # canonical size expr -> sids whose candidate set contains it (the
    # exact-match fast path: identical sizes are an EQ fit by definition)
    by_expr: Dict[SymbolicExpr, List[int]] = {}
    # (rep_size, sid) sorted: placement scans candidate hosts from a value's
    # own representative size upward instead of testing every slot
    size_index: List[Tuple[int, int]] = []

    def new_slot(iv: LiveInterval, external: bool) -> SlotInfo:
        lo, hi = sg.bounds_of(iv.nbytes_expr)
        s = SlotInfo(sid=len(slots), external=external,
                     size_exprs=[iv.nbytes_expr],
                     size_lo=lo, size_hi=hi,
                     rep_size=rep_eval(iv.nbytes_expr))
        s.add_member(iv.vid, iv.start, iv.end)
        slots.append(s)
        bisect.insort(size_index, (s.rep_size, s.sid))
        by_expr.setdefault(sg.canonicalize(iv.nbytes_expr), []).append(s.sid)
        return s

    # caller-provided buffers first: external slots, occupied from step -1
    for v in list(graph.inputs) + list(graph.consts):
        iv = liveness.get(v.id)
        if iv is None:
            continue
        s = new_slot(iv, external=True)
        assignment[v.id] = SlotAssignment(v.id, s.sid, provable=True,
                                          reused=False, donated=False)

    # global decreasing-size best-fit: biggest worst-case values found the
    # slots, smaller ones fill the gaps
    intermediates = sorted(
        (iv for iv in liveness.values() if not iv.external),
        key=lambda iv: (-rep_eval(iv.nbytes_expr), iv.start, iv.vid))

    plan = ArenaPlan(slots=slots, assignment=assignment, liveness=liveness,
                     donate_inputs=donate_inputs, horizon=len(order))

    for iv in intermediates:
        plan.n_assigned += 1
        chosen: Optional[SlotInfo] = None
        provable = False
        v_rep = rep_eval(iv.nbytes_expr)
        v_lo, v_hi = sg.bounds_of(iv.nbytes_expr)

        # 1. exact-expression match (EQ fit, no comparison machinery needed)
        canon = sg.canonicalize(iv.nbytes_expr)
        for sid in by_expr.get(canon, ()):
            if slots[sid].can_host(iv.start, iv.end):
                chosen, provable = slots[sid], True
                break

        if chosen is None:
            # 2. provable fit via symbolic comparison, tightest slot first —
            #    scan the (rep_size, sid) index upward from the value's own
            #    representative size; liveness overlap is checked lazily so
            #    slots below v_rep are never bisected at all
            probes = 0
            start = bisect.bisect_left(size_index, (v_rep, -1))
            for j in range(start, len(size_index)):
                if probes >= _MAX_FIT_PROBES:
                    break
                s = slots[size_index[j][1]]
                if not s.can_host(iv.start, iv.end):
                    continue
                probes += 1
                # interval prefilter: hi(value) <= lo(slot size) proves fit
                if v_hi is not None and s.size_lo is not None \
                        and v_hi <= s.size_lo:
                    chosen, provable = s, True
                    break
                if any(sg.compare(iv.nbytes_expr, e) in (Cmp.LT, Cmp.LE, Cmp.EQ)
                       for e in s.size_exprs):
                    chosen, provable = s, True
                    break

            # 3. checked reuse: best fit at the representative env — fit is
            #    plausible but unproven, so the runtime sizes the slot per
            #    env and may grow it.  External (donated) buffers cannot
            #    grow, so they only take provable members.
            if chosen is None:
                for j in range(start, len(size_index)):   # tightest first
                    s = slots[size_index[j][1]]
                    if not s.external and s.can_host(iv.start, iv.end):
                        chosen = s
                        break
                if chosen is None:   # nothing at least v_rep: grow the biggest
                    growable = [s for s in slots
                                if not s.external
                                and s.can_host(iv.start, iv.end)]
                    if growable:
                        chosen = max(growable, key=lambda s: s.rep_size)
                if chosen is not None and iv.nbytes_expr not in chosen.size_exprs:
                    chosen.size_exprs.append(iv.nbytes_expr)
                    chosen.size_lo = None if (chosen.size_lo is None or v_lo is None) \
                        else max(chosen.size_lo, v_lo)
                    chosen.size_hi = None if (chosen.size_hi is None or v_hi is None) \
                        else max(chosen.size_hi, v_hi)
                    if v_rep > chosen.rep_size:
                        i = bisect.bisect_left(
                            size_index, (chosen.rep_size, chosen.sid))
                        del size_index[i]
                        chosen.rep_size = v_rep
                        bisect.insort(size_index,
                                      (chosen.rep_size, chosen.sid))
                    bucket = by_expr.setdefault(canon, [])
                    if chosen.sid not in bucket:
                        bucket.append(chosen.sid)

        if chosen is None:
            s = new_slot(iv, external=False)
            assignment[iv.vid] = SlotAssignment(iv.vid, s.sid, provable=True,
                                                reused=False, donated=False)
            continue

        chosen.add_member(iv.vid, iv.start, iv.end)
        assignment[iv.vid] = SlotAssignment(iv.vid, chosen.sid,
                                            provable=provable, reused=True,
                                            donated=chosen.external)

    _recount(plan)
    _add_loop_slots(plan, graph, order, sg, rep_eval)

    # hi: every resolved arena is capped by Σ non-external slot capacities,
    # so Σ per-slot interval highs is a guaranteed upper bound.  lo: the
    # packed reserve is at least as tall as its biggest single block, so
    # the largest arena-served value at its smallest in-range size is a
    # guaranteed lower bound (per-slot lows do NOT sum — address packing
    # can overlap whole slots in time).
    lo_max, hi_sum = 0, 0
    for s in plan.slots:
        if s.external:
            continue
        hi_sum = None if (hi_sum is None or s.size_hi is None) \
            else hi_sum + s.size_hi
    for vid, asg in assignment.items():
        iv = liveness.get(vid)
        if iv is None:  # loop-internal runtime keys have no outer interval
            continue
        if iv.external or plan.slots[asg.sid].external:
            continue  # served from caller buffers, not the arena
        lo = sg.bounds_of(iv.nbytes_expr)[0]
        if lo is not None:
            lo_max = max(lo_max, lo)
    plan.arena_bound_lo = lo_max
    plan.arena_bound_bytes = hi_sum
    return plan


def _recount(plan: ArenaPlan) -> None:
    """Recompute the reuse counters from the final assignment flags."""
    plan.n_reused = plan.n_provable_reuses = 0
    plan.n_checked_reuses = plan.n_donated_reuses = 0
    for vid, asg in plan.assignment.items():
        if plan.liveness[vid].external or not asg.reused:
            continue
        plan.n_reused += 1
        if asg.provable:
            plan.n_provable_reuses += 1
        else:
            plan.n_checked_reuses += 1
        if asg.donated:
            plan.n_donated_reuses += 1


def _add_loop_slots(plan: ArenaPlan, graph: Graph, order: Sequence[Node],
                    sg: ShapeGraph, rep_eval) -> None:
    """Project each rolled loop's *body* arena plan into the outer plan.

    Every non-external body slot becomes an outer slot reserved at the
    loop's position — doubled when it hosts a produced loop carry, because
    two carry generations (iterations ``i-1`` and ``i``) are live at once
    across the back-edge.  Used ``xs`` slices and body constants get one
    slot each.  The runtime addresses these buffers with tuple keys
    ``(loop_node_id, parity, body_value_id)`` (parity 2 = loop constants);
    the key-agnostic ``assignment`` dict routes them to their outer slot,
    so cross-iteration reuse falls out of the ordinary slot discipline and
    the steady-state arena contribution is independent of the trip count.

    Slot members being freed and re-allocated every iteration is exactly
    the in-place update pattern the paper targets: the loop's footprint is
    one iteration's worth of buffers (×2 for carries), not ``t``'s worth.
    """
    from ..ir.loop import loop_body_of

    # synthetic vids index the pseudo liveness entries used for address
    # packing; real value ids are dense [0, len(values)), so this is free
    next_vid = len(graph.values)

    for p, n in enumerate(order):
        body = loop_body_of(n)
        if body is None:
            continue
        lp = body.plan(sg)

        def add_slot(size_exprs, size_lo, size_hi, rep_size) -> int:
            nonlocal next_vid
            svid = next_vid
            next_vid += 1
            s = SlotInfo(sid=len(plan.slots), external=False,
                         size_exprs=list(size_exprs),
                         size_lo=size_lo, size_hi=size_hi, rep_size=rep_size)
            s.add_member(svid, p, p)
            plan.slots.append(s)
            plan.liveness[svid] = LiveInterval(
                vid=svid, start=p, end=p, nbytes_expr=s.size_expr,
                kind="intermediate", is_output=False)
            plan.assignment[svid] = SlotAssignment(
                svid, s.sid, provable=True, reused=False, donated=False)
            return s.sid

        for s in lp.body_arena.slots:
            if s.external:
                continue
            doubled = any(m in lp.carry_member_ids for m in s.members)
            sids = [add_slot(s.size_exprs, s.size_lo, s.size_hi, s.rep_size)
                    for _ in range(2 if doubled else 1)]
            for m in s.members:
                for par in (0, 1):
                    key = (n.id, par, m)
                    plan.assignment[key] = SlotAssignment(
                        key, sids[par] if doubled else sids[0],
                        provable=True, reused=False, donated=False)
        for j, x in enumerate(lp.x_in):
            if not lp.x_used[j]:
                continue
            e = lp.sizes[x.id]
            lo, hi = sg.bounds_of(e)
            sid = add_slot([e], lo, hi, rep_eval(e))
            for par in (0, 1):
                key = (n.id, par, x.id)
                plan.assignment[key] = SlotAssignment(
                    key, sid, provable=True, reused=False, donated=False)
        for cid in lp.const_ids:
            e = lp.sizes[cid]
            lo, hi = sg.bounds_of(e)
            sid = add_slot([e], lo, hi, rep_eval(e))
            key = (n.id, 2, cid)
            plan.assignment[key] = SlotAssignment(
                key, sid, provable=True, reused=False, donated=False)
