"""The lowered executable artifact: a flat ``Program`` of typed instructions.

``lower_plan`` (see :mod:`.lower`) compiles each (schedule, remat plan,
arena plan) triple into a :class:`Program` — the runtime analogue of
Relax's VM executable and SoD²'s pre-derived dynamic decisions: every
decision the compile half *can* fix is burned into the instruction
stream, so the per-call work left is calling ops.

* value ids are renumbered to **dense registers** (list indices, not
  dict probes);
* buffer frees happen at statically-known death points
  (:class:`FreeSlot` / :class:`Donate` instructions) instead of runtime
  refcounting — dropping the register's reference is what lets PyTorch's
  caching allocator take the storage back;
* the evict check and regeneration guards exist only as explicit
  :class:`MaybeEvict` / :class:`Regen` instructions, emitted solely when
  the compile-time interval bounds cannot rule eviction out;
* regeneration subgraphs are lowered inline as register-addressed
  sub-programs (:class:`RegenProgram`, exported by
  ``repro_torch.core.remat.export.export_regen_programs``);
* every symbolic quantity (buffer sizes, symbolic op arguments, recompute
  FLOPs, arena slot sizes/offsets) is attached as a precompiled
  expression, and :meth:`Program.resolve` evaluates them all for one dim
  binding in a single pass — including a replay of the static alloc/free
  sequence that precomputes the call's entire :class:`MemoryStats` when
  eviction is provably off the table for that env.

The instruction set:

========== =================================================================
BindArg     place a caller input / trace constant into its register
Compute     call one op: gather input registers, store outputs
MaybeEvict  the paper's ``Remat::EvictOp`` — ensure the op's output bytes
            fit the limit, evicting victims chosen by the runtime policy
Regen       the paper's ``Remat::RegenerateOp`` guard — rematerialize the
            listed registers (reload, sub-program recompute, or a view
            rebuilt over its regenerated root) if evicted
FreeSlot    release a dead intermediate's buffer (statically placed)
Donate      release a dead caller buffer (only under ``donate_inputs``)
Loop        run a rolled ``scan``: the lowered body sub-Program per
            iteration, registers rebound (see ``ir.loop``)
BindDim     publish a just-measured bounded dim into the call env
Return      gather the output registers
========== =================================================================

Views hold their root's storage (``ir.graph``), so evicting a root also
drops every view register of it that is still set; ``view_src`` records
each view register's producing :class:`Compute`, which re-runs over the
regenerated root when the view is read again.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

from ..executor.memory import MemoryManager, MemoryStats
from ..ir.capture import resolve_leaves
from ..ir.dynamism import complete_bound_env
from ..ir.graph import Graph, Node
from ..memplan.arena import ArenaAllocator
from ..remat.planner import ExecutionPlan
from ..symbolic.expr import SymbolicExpr

# instruction opcodes (small ints: the VM dispatches on them)
OP_BIND_ARG = 0
OP_COMPUTE = 1
OP_MAYBE_EVICT = 2
OP_REGEN = 3
OP_FREE_SLOT = 4
OP_DONATE = 5
OP_RETURN = 6
OP_LOOP = 7
OP_BIND_DIM = 8


@dataclass(frozen=True)
class BindArg:
    """Place flat input ``index`` (or a trace constant) into ``reg``."""
    reg: int
    index: int                 # flat-input position; -1 for consts
    const: Any                 # the constant tensor (kind='const' only)
    vid: int                   # original value id (memory accounting key)
    op: int = OP_BIND_ARG


@dataclass(frozen=True)
class Compute:
    """Call one op over input registers, store selected outputs.

    The op's arguments are ``spec`` unflattened over a leaf list: the
    per-env resolved ``template`` (``ResolvedProgram.leaves[cidx]``) with
    the tensors of ``in_regs`` written at ``arg_slots``.  ``template`` is
    the node's argument template with this plan's kernel variant baked
    in."""
    cidx: int                  # index into resolved leaves / ensure tables
    node: Node
    prim: Any
    multi: bool                # the op returns a list of tensors
    in_regs: Tuple[int, ...]
    arg_slots: Tuple[Tuple[int, int], ...]   # (leaf position, in_regs index)
    spec: Any                  # pytree spec of (args, kwargs)
    # (output position, destination register) for outputs that are kept
    # (consumed later or returned); unkept outputs are simply dropped
    store: Tuple[Tuple[int, int], ...]
    template: Tuple[Any, ...] = ()
    # value-dependent bounded ops only: registers in ``store`` whose
    # accounting alloc is deferred to the following BindDim (the payload —
    # its tight size is only known after measuring), and outputs stored
    # for the BindDim to read but never accounted (the int32 count scalar
    # when nothing downstream consumes it)
    defer_regs: Tuple[int, ...] = ()
    extra_store: Tuple[Tuple[int, int], ...] = ()
    op: int = OP_COMPUTE


@dataclass(frozen=True)
class MaybeEvict:
    """Ensure the next Compute's output bytes fit the memory limit.

    Emitted only when lowering cannot prove eviction impossible (a limit
    below the guaranteed peak).  ``pinned`` are the value ids the
    in-flight op needs live (its inputs + outputs)."""
    cidx: int
    step: int
    pinned: frozenset
    op: int = OP_MAYBE_EVICT


@dataclass(frozen=True)
class Regen:
    """Rematerialize ``regs`` (reload, recompute or view rebuild) if they
    were evicted.

    Emitted before a Compute only for inputs that are remat candidates and
    for views of them — the only registers an eviction can ever drop."""
    regs: Tuple[int, ...]
    step: int
    pinned: frozenset
    op: int = OP_REGEN


@dataclass(frozen=True)
class FreeSlot:
    """Release a dead intermediate at its statically-known death point."""
    reg: int
    vid: int
    op: int = OP_FREE_SLOT


@dataclass(frozen=True)
class Donate:
    """Release a dead caller buffer (input/const) under ``donate_inputs``.

    ``counted`` mirrors ``count_inputs``: counted buffers leave through
    the memory manager, uncounted ones only release their arena slot."""
    reg: int
    vid: int
    counted: bool
    op: int = OP_DONATE


@dataclass(frozen=True)
class Return:
    """Gather the output registers (rematerializing evicted ones)."""
    regs: Tuple[int, ...]
    op: int = OP_RETURN


@dataclass(frozen=True)
class BindDim:
    """Publish a just-measured bounded dim into the call env (mid-call).

    Emitted immediately after the Compute that *introduces* bounded dim
    ``name`` (``ir.dynamism``): read the int32 count from ``count_reg`` (a
    device-to-host sync), clamp it to the cap evaluated at the current env
    (a chained introducer counts over its padded input, so the raw count
    may exceed a chained cap), rebind ``name`` in the per-call env,
    refresh the byte sizes of every bound-dependent register and the
    arguments of every bound-dependent Compute, and only *then* run the
    deferred accounting alloc of the payload (``alloc_store``) — so the
    arena records the tight size and every later fit/free/peak sees it.
    The payload in ``payload_reg`` (-1 when unkept) must have the measured
    extent on dim ``axis``.  With ``drop_count`` the count scalar's
    register is nulled after reading (nothing downstream consumes it)."""
    name: str
    cap_expr: SymbolicExpr
    count_reg: int
    alloc_store: Tuple[Tuple[int, int], ...]   # deferred (out pos, reg)
    drop_count: bool
    step: int
    payload_reg: int = -1
    axis: int = 0
    op: int = OP_BIND_DIM


@dataclass(frozen=True)
class Loop:
    """Run a rolled ``scan`` loop: one instruction for the whole trip.

    The body is a lowered sub-:class:`Program` executed once per
    iteration with registers rebound (carries from the previous
    iteration's outputs, ``xs`` slices by index); ``lidx`` indexes the
    owning Program's ``loops`` table.  ``store`` routes the loop's kept
    outer outputs (final carries, stacked ``ys``); ``pinned`` mirrors
    ``MaybeEvict.pinned`` for the hoisted evict check."""
    lidx: int
    in_regs: Tuple[int, ...]
    store: Tuple[Tuple[int, int], ...]
    step: int
    pinned: frozenset
    op: int = OP_LOOP


@dataclass
class LoopInfo:
    """Compile-time half of one rolled loop inside a Program."""
    node: Node                 # the outer loop node
    body: Any                  # ir.loop.LoopBody
    lp: Any                    # ir.loop.LoopPlanInfo (schedule + events)
    body_program: "Program"    # the body lowered once (O(body) size)
    kept: Tuple[bool, ...]     # per outer output: consumed or returned


@dataclass
class ResolvedLoop:
    """One rolled loop realized for a concrete env."""
    trip: int                               # trip count t at this env
    rbody: "ResolvedProgram"                # body program resolve (cached)
    extra_bytes: int                        # exact internal peak delta
    sizes: Dict[int, int]                   # body value id -> bytes
    outer_y: List[Tuple[int, int]]          # kept stacked ys: (vid, bytes)
    outer_carry: List[Optional[Tuple[int, int]]]   # per carry slot


@dataclass(frozen=True)
class RegenStep:
    """One lowered node of a regeneration sub-program.

    ``in_refs`` entries are ``(is_temp, index)`` for the op's tensor
    arguments: a sub-program temp produced by an earlier step, or a
    main-program register (materialized recursively).  ``writes`` routes
    outputs into temp slots; ``out_bytes`` is the step's output size, held
    in the accounting while the sub-program runs."""
    node: Node
    prim: Any
    multi: bool
    cidx: int                  # the node's main-program Compute (leaves)
    arg_slots: Tuple[Tuple[int, int], ...]
    spec: Any
    in_refs: Tuple[Tuple[bool, int], ...]
    writes: Tuple[Tuple[int, int], ...]
    out_bytes: SymbolicExpr


@dataclass(frozen=True)
class RegenProgram:
    """A remat candidate's recompute subgraph, lowered over registers."""
    target_reg: int
    target_vid: int
    source_regs: Tuple[int, ...]
    n_temps: int
    steps: Tuple[RegenStep, ...]
    target_temp: int
    flops_expr: SymbolicExpr


@dataclass
class ResolvedProgram:
    """A :class:`Program` realized for one concrete dim binding.

    Everything symbolic is now a plain int or list: per-register byte
    sizes, per-Compute resolved argument leaves and ensure thresholds,
    per-regen FLOPs and step sizes, the resolved arena, and — when
    ``fast_ok`` — the complete :class:`MemoryStats` of a run, so the hot
    path copies a template instead of accounting per op."""

    env: Dict[str, int]
    nbytes: List[int]                       # per register
    leaves: List[List[Any]]                 # per Compute (cidx)
    ensure_bytes: List[int] = field(default_factory=list)   # per Compute
    regen_flops: Dict[int, int] = field(default_factory=dict)  # target reg
    regen_step_bytes: Dict[int, List[int]] = field(default_factory=dict)
    arena: Optional[Any] = None             # memplan ResolvedArena
    # replay result: the exact free-run stats of this env's call
    stats_template: Optional[MemoryStats] = None
    # True when no MaybeEvict can fire at this env (no limit, or the
    # replayed peak fits it): the VM may run the fast stream.  With bounded
    # dims the replay is at the caps, which bound every measured run
    fast_ok: bool = True
    # per rolled loop (index = Loop.lidx): trip count, body resolve,
    # exact internal peak delta, and the accounting size tables
    loops: List[ResolvedLoop] = field(default_factory=list)


@dataclass
class Program:
    """Flat lowered executable for one ExecutionPlan (see module doc)."""

    plan: ExecutionPlan
    graph: Graph
    n_regs: int
    reg_of: Dict[int, int]                  # value id -> register
    vid_of: List[int]                       # register -> value id
    nbytes_exprs: List[SymbolicExpr]        # per register
    instructions: List[Any]                 # full stream (evict path included)
    fast_instructions: List[Any]            # stream without MaybeEvict/Regen
    computes: List[Compute]
    # per Compute: the template leaves when they hold nothing symbolic
    # (used as-is), else None -> resolved per env in resolve()
    static_leaves: List[Optional[List[Any]]]
    out_regs: Tuple[int, ...]
    donate_inputs: bool
    count_inputs: bool
    regen: Dict[int, RegenProgram] = field(default_factory=dict)
    death_step: List[int] = field(default_factory=list)  # -1: never freed
    candidate_regs: Tuple[int, ...] = ()    # remat candidates, register order
    # view register -> (producing Compute, output position); root register
    # -> its view registers (both only for views of remat candidates)
    view_src: Dict[int, Tuple[Compute, int]] = field(default_factory=dict)
    views_of: Dict[int, Tuple[int, ...]] = field(default_factory=dict)
    has_evict_path: bool = False
    memory_limit: Optional[int] = None
    # rolled loops (index = Loop.lidx); each body is itself a Program,
    # lowered once — the stream stays O(body), not O(t·body)
    loops: List[LoopInfo] = field(default_factory=list)
    # bounded dim name -> registers whose byte size mentions it, and the
    # Computes whose arguments do (refreshed by the BindDim that publishes
    # the measured value)
    bound_dep_regs: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    bound_dep_cidx: Dict[str, Tuple[int, ...]] = field(default_factory=dict)

    def __post_init__(self):
        self._resolve_cache: Dict[Tuple, ResolvedProgram] = {}

    @property
    def has_bound_dims(self) -> bool:
        return bool(self.graph.bound_dims)

    @property
    def n_instructions(self) -> int:
        return len(self.instructions)

    def counts(self) -> Dict[str, int]:
        """Instruction histogram (docs/tests introspection)."""
        names = {OP_BIND_ARG: "BindArg", OP_COMPUTE: "Compute",
                 OP_MAYBE_EVICT: "MaybeEvict", OP_REGEN: "Regen",
                 OP_FREE_SLOT: "FreeSlot", OP_DONATE: "Donate",
                 OP_RETURN: "Return", OP_LOOP: "Loop",
                 OP_BIND_DIM: "BindDim"}
        out = {name: 0 for name in names.values()}
        for inst in self.instructions:
            out[names[inst.op]] += 1
        return out

    # ---------------------------------------------------------------- resolve
    def resolve(self, env: Dict[str, int]) -> ResolvedProgram:
        """Evaluate every attached expression for ``env`` in one pass.

        Cached per env (serving and training repeat shapes)."""
        key = tuple(sorted(env.items()))
        out = self._resolve_cache.get(key)
        if out is not None:
            return out
        if len(self._resolve_cache) > 64:
            self._resolve_cache.clear()
        # value-dependent bounded dims absent from the env evaluate at
        # their cap.  Completion is deterministic in the declared env, so
        # the declared-env cache key stays sound: cached sizes are cap
        # sizes, and measured values live only in per-call overlays (the
        # VM's env/size/argument overlays) — two calls with equal declared
        # dims but different measured bounds never alias each other.
        if self.graph.bound_dims:
            env = complete_bound_env(self.graph, env)

        nbytes = [expr.evaluate(env) for expr in self.nbytes_exprs]
        leaves = [static if static is not None
                  else resolve_leaves(comp.template, env)
                  for comp, static in zip(self.computes, self.static_leaves)]
        ensure = [sum(nbytes[r] for _oi, r in comp.store)
                  for comp in self.computes]
        regen_flops = {reg: max(1, rp.flops_expr.evaluate(env))
                       for reg, rp in self.regen.items()}
        regen_step_bytes = {reg: [st.out_bytes.evaluate(env)
                                  for st in rp.steps]
                            for reg, rp in self.regen.items()}
        arena = None
        if self.plan.arena_plan is not None:
            arena = self.plan.arena_plan.resolve(env)

        # rolled loops: resolve each body sub-program (its own cache), and
        # evaluate the loop's trip count, exact internal peak delta, and
        # accounting size tables
        rloops: List[ResolvedLoop] = []
        for info in self.loops:
            trip = info.body.length_expr.evaluate(env)
            rbody = info.body_program.resolve(env)
            bsizes = {bvid: e.evaluate(env)
                      for bvid, e in info.lp.sizes.items()}
            nk = info.body.num_carry
            node = info.node
            outer_y = [(ov.id, nbytes[self.reg_of[ov.id]])
                       for ov, k in zip(node.outvals[nk:], info.kept[nk:])
                       if k]
            outer_carry = [(ov.id, nbytes[self.reg_of[ov.id]]) if k else None
                           for ov, k in zip(node.outvals[:nk],
                                            info.kept[:nk])]
            extra = info.lp.peak_expr_for(node, info.kept,
                                          trip).evaluate(env)
            rloops.append(ResolvedLoop(trip=trip, rbody=rbody,
                                       extra_bytes=extra, sizes=bsizes,
                                       outer_y=outer_y,
                                       outer_carry=outer_carry))

        out = ResolvedProgram(env=dict(env), nbytes=nbytes, leaves=leaves,
                              ensure_bytes=ensure, regen_flops=regen_flops,
                              regen_step_bytes=regen_step_bytes, arena=arena,
                              loops=rloops)
        out.stats_template = self._replay_stats(out)
        out.fast_ok = (self.memory_limit is None or
                       out.stats_template.device_peak <= self.memory_limit)
        self._resolve_cache[key] = out
        return out

    def _replay_stats(self, resolved: ResolvedProgram,
                      measured: Optional[Dict[str, int]] = None
                      ) -> MemoryStats:
        """Replay the static alloc/free sequence once for this env.

        The fast stream's memory traffic is fully determined by the env
        (no eviction can reorder it), so the whole run's MemoryStats —
        device peak, arena size, reuse ratio, fragmentation — is a
        compile-side fact the hot path copies instead of recomputing.

        ``measured`` (bounded dims only) gives each BindDim its measured
        extent: the replay then refreshes the bound-dependent sizes there,
        exactly as the dynamic stream does mid-call.  Without it the
        deferred payload allocs land at the resolving env's sizes (the
        caps for a declared env)."""
        nbytes = resolved.nbytes
        env_run = resolved.env
        if measured is not None:
            nbytes = list(nbytes)
            env_run = dict(env_run)
        arena = None
        if resolved.arena is not None:
            arena = ArenaAllocator(self.plan.arena_plan, resolved.arena)
        mm = MemoryManager(arena=arena)
        vid_of = self.vid_of
        for inst in self.fast_instructions:
            op = inst.op
            if op == OP_COMPUTE:
                for _oi, r in inst.store:
                    if r not in inst.defer_regs:
                        mm.alloc(vid_of[r], nbytes[r])
            elif op == OP_BIND_ARG:
                if arena is not None:
                    arena.place_external(inst.vid, nbytes[inst.reg])
                if self.count_inputs:
                    mm.alloc(inst.vid, nbytes[inst.reg])
            elif op == OP_FREE_SLOT:
                mm.free(inst.vid)
            elif op == OP_DONATE:
                if inst.counted:
                    mm.free(inst.vid)
                else:
                    mm.arena_release(inst.vid)
            elif op == OP_BIND_DIM:
                if measured is not None:
                    env_run[inst.name] = measured[inst.name]
                    mm.stats.measured_dims[inst.name] = measured[inst.name]
                    for r in self.bound_dep_regs[inst.name]:
                        nbytes[r] = self.nbytes_exprs[r].evaluate(env_run)
                for _oi, r in inst.alloc_store:
                    mm.alloc(vid_of[r], nbytes[r])
            elif op == OP_LOOP:
                # the shared event engine replays the loop's alloc/free
                # sequence — identical to what the interpreter and the VM
                # dynamic stream drive through their MemoryManagers
                rl = resolved.loops[inst.lidx]
                info = self.loops[inst.lidx]
                info.lp.account(mm, info.node.id, rl.trip,
                                rl.sizes.__getitem__, rl.outer_y,
                                rl.outer_carry)
        if arena is not None:
            arena.write_stats(mm.stats)
        return mm.stats

    def stats_for(self, resolved: ResolvedProgram,
                  measured: Optional[Dict[str, int]] = None) -> MemoryStats:
        """A fresh per-call copy of the precomputed stats template; with
        ``measured`` (a bounded program's BindDim values), the replay at
        those extents."""
        if measured is None:
            return replace(resolved.stats_template, measured_dims={})
        return self._replay_stats(resolved, measured)
