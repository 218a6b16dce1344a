"""Symbolic control flow: the rolled ``scan`` loop node, and the opaque
scan node (:class:`OpaqueScan`) of a scan the roll gate refuses.

Port of ``repro/core/ir/loop.py``.  A ``torch.ops.higher_order.scan``
whose ``xs`` have a *symbolic* length ``t`` becomes one :class:`Node` in
the outer graph whose params carry a :class:`LoopBody`: the body captured
once as a sub-``Graph`` (t-free — its inputs hold the per-iteration
slices), the carried values declared explicitly by position, and the trip
count attached as a ``SymbolicExpr``.

Input order.  Torch's scan passes its body ``(carries, xs slices,
additional inputs)``; the reference's body takes ``(consts, carries,
xs)``.  Capture puts the body graph's inputs, and the loop node's, in the
reference's order (a scan's additional inputs are its consts) and records
the torch position of each in :attr:`LoopBody.torch_index`, so every
field here keeps the reference's meaning.  The whole
pipeline then works on ``O(body)`` structure instead of ``O(t·body)``:
the body is scheduled once, its arena plan is built once, remat decisions
are hoisted out (loop outputs are remat barriers), and lowering emits a
single ``Loop`` instruction running a lowered sub-``Program``.

Memory discipline (the back-edge liveness rules, see
``docs/architecture.md``):

* per-iteration temporaries die at their last in-iteration consumer and
  their buffers are reused across iterations — the steady-state arena
  contribution of the loop is independent of ``t``;
* loop-carried values stay live across the back-edge: iteration ``i``'s
  carry is freed in iteration ``i+1`` after its last consumer there (two
  buffer generations alternate, hence the *parity* in the runtime keys);
* ``xs`` slices live from the iteration preamble to their last consumer;
* stacked ``ys`` and final carries are ordinary outer values, allocated
  on loop entry / exit and owned by the outer plan.  The executors make
  this real on the device: each ``ys`` output is allocated whole on entry
  and every iteration's ``y`` is copied into its row, and a carry's
  previous generation is dropped at its last use in the next iteration.

Every executor (reference interpreter, VM dynamic path, and the
resolve-time stats replay behind the VM fast path) accounts the loop
through the single :meth:`LoopPlanInfo.account` event engine, so their
``MemoryStats`` agree by construction.  Buffers inside the loop are keyed
``(node_id, parity, body_value_id)`` — the :class:`MemoryManager` and
:class:`ArenaAllocator` are key-agnostic dicts, so the same machinery
serves both outer values (int vids) and loop-internal generations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..symbolic import SymbolicExpr, ZERO
from .graph import Graph, Node, Value

# params key marking a rolled loop node; the value is the LoopBody
LOOP_PARAM = "_loop_body"


class OpaqueScan:
    """The op of an *opaque* scan node: a scan the roll gate refuses (a
    static length, a bounded dim in the body, a carry passed through to
    another slot, a scan inside a rolled body) stays one node, as the
    reference keeps it (``repro/core/ir/trace.py:181-204``).

    Called as ``op(init, xs, additional)`` (torch's operand groups), it
    runs the captured body (the scan's fx ``GraphModule``) in forward
    order over the leading dim of ``xs`` and stacks the ``ys``: the
    reference's ``lax.scan`` semantics.  The plan counts the node's
    outputs only; what the body allocates while it runs is outside
    ``device_peak``, as it is outside the reference's.  A scan nested in
    the body runs through the same loop (``_own_nested_scans``)."""

    def __init__(self, body: Any, num_carry: int):
        _own_nested_scans(body)
        self.body = body
        self.num_carry = num_carry

    def __call__(self, init: Sequence[torch.Tensor],
                 xs: Sequence[torch.Tensor], additional: Sequence[Any]
                 ) -> List[torch.Tensor]:
        nk = self.num_carry
        carries = list(init)
        n = xs[0].shape[0]
        ys: List[torch.Tensor] = []
        for i in range(n):
            out = self.body(*carries, *[x[i] for x in xs], *additional)
            carries = list(out[:nk])
            if i == 0:
                # stacked outputs allocated whole on the first step: what
                # stacking the ys gives, without holding them all twice
                ys = [torch.empty((n,) + tuple(y.shape), dtype=y.dtype,
                                  device=y.device) for y in out[nk:]]
            for buf, y in zip(ys, out[nk:]):
                buf[i].copy_(y)
            del out
        # a final carry that is a view would pin its body's base
        return [c.clone() if c._is_view() else c for c in carries] + ys


def _run_scan(combine: Any, init: Sequence[torch.Tensor],
              xs: Sequence[torch.Tensor], additional: Sequence[Any]
              ) -> List[torch.Tensor]:
    """``torch.ops.higher_order.scan``'s signature, run by
    :class:`OpaqueScan`'s loop."""
    return OpaqueScan(combine, len(init))(init, xs, additional)


def _own_nested_scans(gm: Any) -> None:
    """Route the scans inside a captured body through :func:`_run_scan`,
    so an opaque body runs every level of nesting by the same loop."""
    changed = False
    for n in gm.graph.nodes:
        if n.op == "call_function" and \
                n.target is torch.ops.higher_order.scan:
            n.target = _run_scan
            changed = True
    if changed:
        gm.recompile()


def loop_body_of(node: Node) -> Optional["LoopBody"]:
    body = node.params.get(LOOP_PARAM)
    return body if isinstance(body, LoopBody) else None


def is_loop_node(node: Node) -> bool:
    return isinstance(node.params.get(LOOP_PARAM), LoopBody)


def rollable_body(bg: Graph, num_consts: int, num_carry: int) -> bool:
    """Whether a traced scan body admits the rolled memory discipline.

    Every carry output must be (a) produced by a body node, (b) the
    *same-slot* carry input passed through, or (c) a trace constant.
    Cross-slot pass-through (e.g. a carry swap) would make one array's
    lifetime span an unbounded number of iterations, breaking the
    two-generation (parity) buffer scheme — such scans stay opaque.
    """
    carry_in = bg.inputs[num_consts:num_consts + num_carry]
    for j, ov in enumerate(bg.outputs[:num_carry]):
        if ov.kind == "intermediate":
            if ov.producer is None:
                return False
            continue
        if ov.kind == "const":
            continue
        if ov is not carry_in[j]:       # cross-slot / xs / const-arg reuse
            return False
    return True


@dataclass
class LoopBody:
    """A scan loop's traced body + carry/xs declaration (IR-level)."""

    graph: Graph                 # body sub-graph; inputs = consts+carries+xs
    num_consts: int
    num_carry: int
    num_xs: int
    length_expr: SymbolicExpr    # symbolic trip count t
    # per body input (reference order): its position in torch's body
    # signature (carries, xs slices, additional inputs)
    torch_index: Tuple[int, ...] = ()
    # per-shape-graph compile artifacts, memoized (the held sg reference
    # keeps id() valid for the lifetime of the entry)
    _plans: Dict[int, Tuple[Any, "LoopPlanInfo"]] = field(
        default_factory=dict, repr=False, compare=False)

    def plan(self, shape_graph) -> "LoopPlanInfo":
        key = id(shape_graph)
        hit = self._plans.get(key)
        if hit is not None:
            return hit[1]
        if len(self._plans) > 32:
            self._plans.clear()
        lp = _build_plan_info(self, shape_graph)
        self._plans[key] = (shape_graph, lp)
        return lp


class _SymSink:
    """Symbolic alloc/free replay: running live-byte expression + the
    per-event peak candidates (deduped by expr uid)."""

    def __init__(self):
        self._live: Dict[Any, SymbolicExpr] = {}
        self.running: SymbolicExpr = ZERO
        self._cand: Dict[int, SymbolicExpr] = {}

    def alloc(self, key, size) -> None:
        self._live[key] = size
        self.running = self.running + size
        self._cand[self.running.uid] = self.running

    def free(self, key) -> None:
        self.running = self.running - self._live.pop(key)

    def peak(self) -> SymbolicExpr:
        out = ZERO
        for e in self._cand.values():
            out = SymbolicExpr.max_of(out, e)
        return out


@dataclass
class LoopPlanInfo:
    """Per-(body, shape-graph) compile artifacts: the body schedule, the
    body arena plan, and the iteration alloc/free event templates every
    executor replays through :meth:`account`."""

    body: LoopBody
    order: List[Node]                      # body schedule (computed once)
    n_steps: int
    body_arena: Any                        # body-level ArenaPlan
    # role vectors (body value ids / Values)
    carry_in: List[Value]
    carry_out: List[Value]
    y_out: List[Value]
    x_in: List[Value]
    x_used: Tuple[bool, ...]
    passthrough: Tuple[bool, ...]          # per carry slot
    const_ids: Tuple[int, ...]             # body consts with consumers
    carry_member_ids: frozenset            # produced carry vids (parity-doubled)
    # event templates (body value ids)
    iter_allocs: Tuple[Tuple[int, ...], ...]   # per position
    iter_frees: Tuple[Tuple[int, ...], ...]    # per position (same iteration)
    prev_frees: Dict[int, Tuple[int, ...]]     # pos (-1..n_steps) -> prev-iter carries
    boundary_frees: Tuple[int, ...]            # iteration end
    sizes: Dict[int, SymbolicExpr]             # bvid -> nbytes expr (event vids)
    _peak_memo: Dict[Tuple, Dict[int, SymbolicExpr]] = field(
        default_factory=dict, repr=False)

    # ------------------------------------------------------------- accounting
    def account(self, sink, nid: int, trip: int,
                size_of: Callable[[int], Any],
                outer_y: Sequence[Tuple[Any, Any]],
                outer_carry: Sequence[Optional[Tuple[Any, Any]]]) -> None:
        """Replay the loop's full alloc/free event sequence against ``sink``
        (``.alloc(key, size)`` / ``.free(key)`` — a ``MemoryManager``, a
        plain counter, or the symbolic :class:`_SymSink`).

        ``size_of(bvid)`` sizes body values; ``outer_y`` are the kept
        stacked outputs as ``(outer key, size)`` pairs, ``outer_carry`` one
        entry per carry slot (``None`` when the outer value is unkept).
        Internal buffers are keyed ``(nid, parity, bvid)``; parity 2 holds
        loop-entry constants.
        """
        for key, size in outer_y:
            sink.alloc(key, size)
        for cid in self.const_ids:
            sink.alloc((nid, 2, cid), size_of(cid))
        n_steps = self.n_steps
        for i in range(trip):
            par = i & 1
            prev = par ^ 1
            if i > 0:
                for vid in self.prev_frees.get(-1, ()):
                    sink.free((nid, prev, vid))
            for j, x in enumerate(self.x_in):
                if self.x_used[j]:
                    sink.alloc((nid, par, x.id), size_of(x.id))
            for p in range(n_steps):
                for vid in self.iter_allocs[p]:
                    sink.alloc((nid, par, vid), size_of(vid))
                for vid in self.iter_frees[p]:
                    sink.free((nid, par, vid))
                if i > 0:
                    for vid in self.prev_frees.get(p, ()):
                        sink.free((nid, prev, vid))
            for vid in self.boundary_frees:
                sink.free((nid, par, vid))
            if i > 0:
                for vid in self.prev_frees.get(n_steps, ()):
                    sink.free((nid, prev, vid))
        # exit: transfer final carries to their outer values, drop consts
        last = (trip - 1) & 1
        freed = set()
        for j, out_pair in enumerate(outer_carry):
            ov = self.carry_out[j]
            if trip > 0 and not self.passthrough[j] and ov.id not in freed:
                sink.free((nid, last, ov.id))
                freed.add(ov.id)
            if out_pair is not None:
                sink.alloc(out_pair[0], out_pair[1])
        for cid in self.const_ids:
            sink.free((nid, 2, cid))

    def peak_exprs(self, node: Node, kept: Sequence[bool]) -> Dict[int, SymbolicExpr]:
        """Symbolic internal-peak expressions, keyed by a trip-count model.

        The event profile of every iteration past the first is identical
        (same sizes, zero net change), so the exact peak of a ``T``-trip
        run is the ``min(T, 2)``-trip replay's peak — three expressions
        cover every trip count, each exact once evaluated at the env
        (the stacked-``ys`` entry allocation keeps its ``t`` factor).
        """
        key = (node.id, tuple(bool(k) for k in kept))
        out = self._peak_memo.get(key)
        if out is not None:
            return out
        nk = self.body.num_carry
        outer_y = [(ov.id, ov.nbytes_expr)
                   for ov, k in zip(node.outvals[nk:], kept[nk:]) if k]
        outer_carry = [(ov.id, ov.nbytes_expr) if k else None
                       for ov, k in zip(node.outvals[:nk], kept[:nk])]
        out = {}
        for t_model in (0, 1, 2):
            sink = _SymSink()
            self.account(sink, node.id, t_model,
                         lambda vid: self.sizes[vid], outer_y, outer_carry)
            out[t_model] = sink.peak()
        self._peak_memo[key] = out
        return out

    def peak_expr_for(self, node: Node, kept: Sequence[bool],
                      trip: int) -> SymbolicExpr:
        return self.peak_exprs(node, kept)[min(trip, 2)]

    def peak_bound_expr(self, node: Node, kept: Sequence[bool],
                        shape_graph) -> SymbolicExpr:
        """Sound symbolic peak over every in-range trip count: the max of
        the trip-model expressions the declared range of ``t`` admits."""
        t_iv = self.body.length_expr.interval(shape_graph.bound_env())
        lo = 0 if t_iv.lo is None else t_iv.lo
        hi = t_iv.hi
        exprs = self.peak_exprs(node, kept)
        out = None
        for t_model in (0, 1, 2):
            if t_model < 2:       # model covers exactly trip == t_model
                feasible = lo <= t_model and (hi is None or hi >= t_model)
            else:                 # model 2 covers every trip >= 2
                feasible = hi is None or hi >= 2
            if feasible:
                e = exprs[t_model]
                out = e if out is None else SymbolicExpr.max_of(out, e)
        return out if out is not None else ZERO

    # -------------------------------------------------------------- execution
    def execute(self, ins: Sequence[Any], trip: int, env: Dict[str, int],
                call: Callable[[Node, List[Any]], List[Any]]) -> List[Any]:
        """Run the body ``trip`` times op-by-op (reference semantics).

        Pure execution — accounting is :meth:`account`'s job.  ``call(node,
        args)`` runs one body node on its argument tensors.  Returns the
        outer output tensors: final carries then stacked ``ys``.
        """
        body = self.body
        bg = body.graph
        nc, nk = body.num_consts, body.num_carry
        benv: Dict[int, Any] = {}
        for v, a in zip(bg.inputs[:nc], ins[:nc]):
            benv[v.id] = a
        for c in bg.consts:
            benv[c.id] = c.const_val
        carries = list(ins[nc:nc + nk])
        # one unbind per used xs (views), not one slice per iteration
        xs = [x.unbind(0) if self.x_used[j] else None
              for j, x in enumerate(ins[nc + nk:])]
        ys = stacked_outputs(self.y_out, trip, env, carries[0].device)
        for i in range(trip):
            for v, a in zip(self.carry_in, carries):
                benv[v.id] = a
            for j, v in enumerate(self.x_in):
                if self.x_used[j]:
                    benv[v.id] = xs[j][i]
            for n in self.order:
                outs = call(n, [benv[iv.id] for iv in n.invals[:n.n_args]])
                for ov, oa in zip(n.outvals, outs):
                    benv[ov.id] = oa
            carries = [benv[v.id] for v in self.carry_out]
            for y, v in zip(ys, self.y_out):
                y[i].copy_(benv[v.id])
        return carries + ys


def stacked_outputs(y_out: Sequence[Value], trip: int, env: Dict[str, int],
                    device: torch.device) -> List[torch.Tensor]:
    """The stacked ``ys`` outputs of a ``trip``-iteration run, allocated
    whole on loop entry (iteration ``i`` copies its ``y`` into row ``i``:
    bitwise what stacking the ``y``s gives)."""
    return [torch.empty((trip,) + tuple(int(d.evaluate(env)) for d in v.dims),
                        dtype=v.dtype, device=device) for v in y_out]


def _build_plan_info(body: LoopBody, sg) -> LoopPlanInfo:
    # local imports: scheduling/memplan import ir.graph; keeping these out
    # of module scope avoids the package-level cycle
    from ..memplan.assign import build_arena_plan
    from ..scheduling.scheduler import schedule_graph

    bg = body.graph
    nc, nk = body.num_consts, body.num_carry
    carry_in = bg.inputs[nc:nc + nk]
    x_in = bg.inputs[nc + nk:]
    carry_out = bg.outputs[:nk]
    y_out = bg.outputs[nk:]
    out_ids = {v.id for v in bg.outputs}
    y_ids = {v.id for v in y_out}

    sched = schedule_graph(bg, sg)
    order = list(sched.order)
    n_steps = len(order)
    pos = {n.id: i for i, n in enumerate(order)}
    body_arena = build_arena_plan(bg, order, sg)

    last_use: Dict[int, int] = {}
    for i, n in enumerate(order):
        for iv in n.invals:
            last_use[iv.id] = i

    produced_carries: List[Value] = []
    seen_pc = set()
    for ov in carry_out:
        if ov.kind == "intermediate" and ov.id not in seen_pc:
            produced_carries.append(ov)
            seen_pc.add(ov.id)
    passthrough = tuple(ov.kind != "intermediate" for ov in carry_out)
    x_used = tuple(bool(v.consumers) or v.id in y_ids for v in x_in)
    const_ids = tuple(c.id for c in bg.consts
                      if c.consumers or c.id in out_ids)

    sizes: Dict[int, SymbolicExpr] = {}
    for v in bg.values:
        sizes[v.id] = v.nbytes_expr

    def kept(v: Value) -> bool:
        return bool(v.consumers) or v.id in out_ids

    # per-value in-iteration death position (temps and used xs slices only;
    # carries and ys follow the back-edge / boundary rules below)
    death: Dict[int, int] = {}
    for j, v in enumerate(x_in):
        if not x_used[j]:
            continue
        death[v.id] = n_steps if v.id in y_ids else last_use.get(v.id, -1)
    for v in bg.values:
        if v.kind != "intermediate" or v.producer is None \
                or v.producer.id not in pos or not kept(v):
            continue
        if v.id in seen_pc or v.id in y_ids:
            continue
        death[v.id] = last_use[v.id]

    iter_allocs = tuple(
        tuple(ov.id for ov in n.outvals if kept(ov)) for n in order)
    iter_frees_l: List[Tuple[int, ...]] = []
    for p, n in enumerate(order):
        frees = []
        seen = set()
        for iv in n.invals:
            if iv.id in seen:
                continue
            seen.add(iv.id)
            if death.get(iv.id, -2) == p:
                frees.append(iv.id)
        iter_frees_l.append(tuple(frees))
    iter_frees = tuple(iter_frees_l)

    boundary = [v.id for j, v in enumerate(x_in)
                if x_used[j] and death.get(v.id) == n_steps]
    for v in y_out:
        if v.kind == "intermediate" and v.id not in seen_pc \
                and v.id not in boundary and v.producer is not None \
                and v.producer.id in pos:
            boundary.append(v.id)
    boundary_frees = tuple(dict.fromkeys(boundary))

    # back-edge liveness: iteration i's carry is freed in iteration i+1
    # after the last consumer of the slot(s) it feeds (-1 = preamble,
    # n_steps = iteration end when the carry is also a y / unused)
    prev_frees: Dict[int, List[int]] = {}
    for v in produced_carries:
        deaths = []
        for j in range(nk):
            if carry_out[j].id != v.id:
                continue
            cin = carry_in[j]
            d = n_steps if cin.id in y_ids else last_use.get(cin.id, -1)
            deaths.append(d)
        prev_frees.setdefault(max(deaths), []).append(v.id)

    return LoopPlanInfo(
        body=body, order=order, n_steps=n_steps, body_arena=body_arena,
        carry_in=list(carry_in), carry_out=list(carry_out),
        y_out=list(y_out), x_in=list(x_in), x_used=x_used,
        passthrough=passthrough, const_ids=const_ids,
        carry_member_ids=frozenset(seen_pc),
        iter_allocs=iter_allocs, iter_frees=iter_frees,
        prev_frees={k: tuple(v) for k, v in prev_frees.items()},
        boundary_frees=boundary_frees, sizes=sizes)
