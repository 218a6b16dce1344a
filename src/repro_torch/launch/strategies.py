"""DTensor sharding strategies for the two kernel ops.

``repro_torch::flash_attention`` and ``repro_torch::rmsnorm`` are custom
ops, so DTensor has no rule for them until one is registered; a sharded
step (the dry-run, a restore onto a mesh) then raises ``NotImplementedError``
at its first norm.  :func:`register_kernel_strategies` registers both with
``torch.distributed.tensor.experimental.register_sharding``.  The launch
tooling calls it before it runs a step on DTensors; importing
``kernels.ops`` stays free of ``torch.distributed``.

Each rule lists, per mesh dim, the placements the op computes correctly on
the local shards; DTensor expands them over the mesh and picks the one
that costs the inputs the least redistribution:

* **flash attention** ``q (B, Hq, S, hd), k/v (B, Hkv, T, hd)``:
  everything replicated; the batch sharded on all three (and the output);
  or the heads sharded on all three.  The op pairs local q head ``j`` with
  local kv head ``j // (Hq_local / Hkv_local)``, which is the global
  pairing only when every rank's q heads use exactly its own kv heads:
  when the mesh dims that shard the heads split ``Hkv`` evenly.  Where
  they do not (``gemma_2b``'s one kv head, ``granite_8b``'s 8 on a model
  axis of 16), the rule is dropped from the choice and DTensor gathers the
  heads (q included) instead: each rank then computes all heads of its
  batch rows.  S and T are never sharded (the causal mask reads absolute
  positions).  The backward is the op's plain gradient (``ops.py``
  ``_flash_backward``), run on the local shards at the placements the
  forward ran at (``_LocalFlash``), so its gradients come out there.
* **RMSNorm** ``x (..., d), scale (d,)``: any one leading dim of ``x``
  sharded (or none), the output likewise, ``scale`` replicated.  ``d`` is
  never offered: the mean is over ``d``, so an input sharded there is
  gathered first.

A decode step's KV or latent cache is sharded on its sequence
(``sharding.cache_specs``), which no rule above offers.  Under
:func:`sharded_execution` the three places decode touches it run where it
lies, as XLA partitions the same step: the write (``index_copy``) on
each rank's own rows (``_sharded_index_copy``), the softmax over the keys
reduced across the shards (``_sharded_softmax``), and the attention's
products with the query moved, not the cache (``_cache_product``).

A product with a sharded weight moves whichever side is smaller, as
XLA's partitioner does (``_product_plans``): the weight gathered, or the
rows of the activations moved and the output brought back.  A decode
step's few rows move; a train step, which takes a gradient, gathers its
weights as FSDP does.  An MoE layer's expert products run on each
rank's own experts, the activations dispatched to the expert shard and
combined back by all-to-all (``_expert_product``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Iterator, List, NamedTuple, Tuple

import torch

_REGISTERED = False


def _flash_rules(q, k, v, causal=True, softmax_scale=None, impl=None
                 ) -> List[Tuple[List[Any], List[Any]]]:
    from torch.distributed.tensor import Replicate, Shard
    rest = [None, None, None]       # causal, softmax_scale, impl
    return [([p], [p] * 3 + rest) for p in (Replicate(), Shard(0), Shard(1))]


def _head_shards(spec) -> int:
    """How many ways the mesh splits dim 1 (the heads) of ``spec``."""
    return math.prod(spec.mesh.size(i) for i, p in enumerate(spec.placements)
                     if p.is_shard() and p.dim == 1)


def _heads_aligned(op_spec) -> bool:
    """Each rank's q heads are those of its own kv heads: the head
    shards split ``Hkv`` evenly (and with it ``Hq``)."""
    q, k = op_spec.input_specs[0], op_spec.input_specs[1]
    n = _head_shards(q)
    return n == 1 or (k.shape[1] % n == 0 and q.shape[1] % n == 0)


def _ready(q, k, v) -> bool:
    """q, k and v already stand on one of the flash rules on every mesh
    dim of more than one rank, so DTensor moves none of them."""
    from torch.distributed.tensor import Replicate, Shard
    ok = (Replicate(), Shard(0), Shard(1))
    for i, (a, b, c) in enumerate(zip(q.placements, k.placements,
                                      v.placements)):
        if q.device_mesh.size(i) > 1 and not (a == b == c and a in ok):
            return False
    n = math.prod(q.device_mesh.size(i) for i, p in enumerate(q.placements)
                  if p == Shard(1))
    return k.shape[1] % n == 0


def _moved_flash(func, args, kwargs):
    """Flash attention on inputs DTensor must move first.  A move leaves
    each shard contiguous but keeps the DTensor's global strides, and the
    op lays its output out as q: a q passed as a transposed view would
    then have one layout as a DTensor and another in its shard.  So the
    inputs go in contiguous, and the output comes back laid out as q was
    (the model views it in that layout)."""
    q = args[0]
    out = _LocalFlash.apply(func, kwargs, *(
        tuple(a.contiguous() for a in args[:3]) + tuple(args[3:])))
    order = sorted(range(q.ndim), key=lambda d: -q.stride(d))
    back = sorted(range(q.ndim), key=order.__getitem__)
    return out.permute(order).contiguous().permute(back)


class _LocalFlash(torch.autograd.Function):
    """Flash attention on DTensors whose backward runs on the shards.

    The forward is the op under its rule, which leaves the output on the
    placements q, k and v were computed at.  The op's own backward is
    plain aten ops, and on DTensors each of them would take whatever
    placement DTensor's propagation picks: torch 2.11 gathered the heads
    there, so every model rank ran the whole attention backward and the
    projections' whole weight gradients.  Here the backward moves q, k,
    v and the output gradient to the forward's placements and runs the
    op's backward on the local shards (a batch or head shard is a whole
    attention problem), so dq, dk and dv come back on those placements
    whatever the torch version."""

    @staticmethod
    def forward(ctx, func, kwargs, q, k, v, *rest):
        out = func(q, k, v, *rest, **kwargs)
        ctx.save_for_backward(q, k, v)
        ctx.placements = tuple(out.placements)
        ctx.options = _flash_options(*rest, **kwargs)
        ctx.n_rest = len(rest)
        return out

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor

        from ..kernels.ref import reference_attention_backward
        p = ctx.placements
        q, k, v = ctx.saved_tensors
        local = [t.redistribute(placements=p).to_local()
                 for t in (q, k, v, grad)]
        grads = reference_attention_backward(*local, **ctx.options)
        # each gradient laid out as its input's shard, as its DTensor says
        return (None, None) + tuple(
            DTensor.from_local(
                g if g.stride() == x.stride() else
                torch.empty_like(x).copy_(g), t.device_mesh, p,
                run_check=False, shape=t.shape, stride=t.stride())
            for g, x, t in zip(grads, local, (q, k, v))) + \
            (None,) * ctx.n_rest


def _flash_options(causal=True, softmax_scale=None, impl=None):
    """The options of a flash call that its backward takes."""
    return {"causal": causal, "softmax_scale": softmax_scale}


def _gathered_weight(x, w):
    """``w`` gathered on every mesh dim that shards both it and the rows
    of ``x``: FSDP's gather of a weight at its use."""
    from torch.distributed.tensor import Replicate
    want = [Replicate() if px.is_shard() and px.dim < x.ndim - 1 and
            pw.is_shard() else pw
            for px, pw in zip(x.placements, w.placements)]
    return w if want == list(w.placements) else \
        w.redistribute(placements=want)


class _Plan(NamedTuple):
    """Where a product ``einsum(eq, x, w)`` of global output ``shape``
    runs: the placements ``x`` and ``w`` are moved to, those of the local
    product's output (``out``), and those the output is moved to after it
    (``final``; a pending sum there is all-reduced before it is cut)."""
    eq: str
    shape: Tuple[int, ...]
    x: Tuple[Any, ...]
    w: Tuple[Any, ...]
    out: Tuple[Any, ...]
    final: Tuple[Any, ...]


def _sharded_letter(letters: str, p):
    """The einsum letter ``p`` shards, or ``None`` (replicated or a
    pending sum)."""
    from torch.distributed.tensor import Shard
    return letters[p.dim] if type(p) is Shard else None


def _product_placements(la: str, pa, lb: str, pb, lc: str) -> List[Any]:
    """The placements of ``einsum("la,lb->lc")`` run on local shards at
    ``pa`` and ``pb``, which shard each mesh dim on one shared letter (or
    one operand alone on a letter the other lacks): that letter's dim of
    the output, or a pending sum where it is summed over."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    out = []
    for a, b in zip(pa, pb):
        c = _sharded_letter(la, a) or _sharded_letter(lb, b)
        out.append(Replicate() if c is None else
                   Shard(lc.index(c)) if c in lc else Partial())
    return out


def _shard_bytes(shape, dtype, mesh, placements) -> int:
    """One rank's bytes of a ``shape`` tensor at ``placements`` (a pending
    sum is whole on every rank)."""
    n = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            n[p.dim] = -(-n[p.dim] // mesh.size(i))
    return math.prod(n) * dtype.itemsize


def _product_plans(x, w, lx: str, lw: str, lo: str):
    """The two plans of ``einsum("lx,lw->lo", x, w)`` for a weight ``w``
    sharded on mesh dims that also shard the rows of ``x`` (a letter of
    ``x`` and the output, not of ``w``), and their costs in bytes:

    * (W) the weight gathered on those mesh dims, FSDP's way; its cost
      is the gathered weight's bytes;
    * (R) the rows moved: ``x`` onto the weight's contraction shard
      where the weight shards a summed letter (one all-to-all from its
      rows' shard), gathered where it shards an output letter; the
      output, a pending sum or sharded on the weight's output letter,
      goes back onto the rows (all-reduce and a local cut; one
      all-to-all).  Its cost is the bytes of ``x`` so moved and of the
      output moved back.  ``None`` where a mesh dim would need a move
      this plan does not make.

    Elsewhere both plans are one: an operand replicated on a mesh dim
    the other shards on a shared letter is cut locally, and a weight
    sharded on a letter both operands have and the output keeps (the
    experts) takes ``x`` there too (one all-to-all from a shard of
    another dim, a local cut from ``Replicate``), its output staying on
    the weight's shard.  ``x`` holds no pending sum.

    Returns ``(W, R, cost of W, cost of R)``; the costs are ``None``
    without an (R) plan or where a size is symbolic."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    px, pw = list(x.placements), list(w.placements)
    wx, ww, rx, rw = list(px), list(pw), list(px), list(pw)
    moved, back = [], {}         # mesh dims with rows in conflict
    r_ok = True
    for i, (a, b) in enumerate(zip(px, pw)):
        cx, cw = _sharded_letter(lx, a), _sharded_letter(lw, b)
        if mesh.size(i) == 1 or cx == cw:
            continue
        if cw is None:                         # cut w to x's letter
            if cx in lw:
                ww[i] = rw[i] = Shard(lw.index(cx))
            continue
        if cw in lx and cw in lo:              # an expert dim: x moves
            wx[i] = rx[i] = Shard(lx.index(cw))
            continue
        if cx is None:                         # x replicated
            if cw not in lo:                   # cut its contraction
                wx[i] = rx[i] = Shard(lx.index(cw))
            continue
        if cx in lw:                           # x on a letter w has
            ww[i] = rw[i] = Shard(lw.index(cx))
            r_ok = False
            continue
        # x's rows against the weight's shard: the plans part here
        ww[i] = Replicate()
        moved.append(i)
        back[i] = Shard(lo.index(cx))
        rx[i] = Shard(lx.index(cw)) if cw not in lo else Replicate()

    size = dict(zip(lx, x.shape))
    size.update(zip(lw, w.shape))
    out_shape = tuple(size[c] for c in lo)

    def plan(xp, wp):
        out = _product_placements(lx, xp, lw, wp, lo)
        final = list(out)
        for i, p in back.items():
            if xp[i] != px[i]:
                final[i] = p
        return _Plan(f"{lx},{lw}->{lo}", out_shape, tuple(xp), tuple(wp),
                     tuple(out), tuple(final))
    w_plan = plan(wx, ww)
    r_plan = plan(rx, rw) if moved and r_ok and not any(
            type(p) is Shard and p.dim == rx[i].dim and j != i
            for i in moved if rx[i].is_shard()
            for j, p in enumerate(rx)) else None
    if r_plan is None or not all(type(d) is int
                                 for d in (*x.shape, *w.shape)):
        return w_plan, r_plan, None, None
    cost_w = _shard_bytes(w.shape, w.dtype, mesh, ww)
    cost_r = _shard_bytes(x.shape, x.dtype, mesh, rx) + len(moved) * \
        _shard_bytes(out_shape, x.dtype, mesh, r_plan.out)
    return w_plan, r_plan, cost_w, cost_r


def _rows_move(x, w, lx: str, lw: str, lo: str):
    """The cost rule over :func:`_product_plans`: (W)'s plan, and (R)'s
    where it moves fewer bytes, else ``None`` (a tie, a symbolic size or
    no (R) plan keeps (W))."""
    w_plan, r_plan, cost_w, cost_r = _product_plans(x, w, lx, lw, lo)
    if r_plan is None or cost_w is None or cost_r >= cost_w:
        r_plan = None
    return w_plan, r_plan


def _expert_product(x, w, lx: str, lw: str, lo: str, cache, dispatched):
    """``einsum("lx,lw->lo", x, w)`` for an expert weight (sharded on its
    leading dim, a letter ``x`` and the output share) as
    :class:`_ExpertProduct`.  ``dispatched`` maps each expert mesh dim to
    the letter the block's activations were sharded on there before the
    dispatch (``None``: replicated), for the combine to go back to."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if any(isinstance(p, Partial) for p in x.placements):
        x = _Reduced.apply(x)
    w_plan, r_plan = _rows_move(x, w, lx, lw, lo)
    plan = r_plan or w_plan
    final = list(plan.final)
    for i, (a, b) in enumerate(zip(x.placements, w.placements)):
        c = _sharded_letter(lw, b)
        if x.device_mesh.size(i) == 1 or c is None or c not in lx or \
                c not in lo:
            continue
        if _sharded_letter(lx, a) != c:            # the dispatch
            dispatched[i] = _sharded_letter(lx, a)
        elif i in dispatched:                      # the combine
            back = dispatched.pop(i)
            final[i] = Shard(lo.index(back)) if back and back in lo \
                else Replicate()
    return _ExpertProduct.apply(plan._replace(final=tuple(final)), cache,
                                x, w)


def _all_to_all(t, i: int, src: int, dst: int):
    """``t`` with mesh dim ``i``'s shard moved from tensor dim ``src`` to
    ``dst`` by one all-to-all over that mesh dim: each rank sends its
    ``dst`` chunks, one a peer, and stacks what it gets on ``src`` in the
    peers' order.  ``None`` where that is not the move (a later mesh dim
    shards either dim, or a dim does not split evenly); DTensor then
    moves it."""
    from torch.distributed._functional_collectives import (
        all_to_all_single, wait_tensor)
    from torch.distributed.tensor import DTensor, Shard
    mesh, n = t.device_mesh, t.device_mesh.size(i)
    want = list(t.placements)
    want[i] = Shard(dst)
    ways = [1] * t.ndim
    for j, p in enumerate(want):
        if p.is_shard():
            ways[p.dim] *= mesh.size(j)
    ways[src] *= n
    if any(type(p) is Shard and p.dim in (src, dst)
           for p in list(t.placements)[i + 1:]) or \
            any(type(d) is not int or d % k for d, k in zip(t.shape, ways)):
        return None
    local = t.to_local()
    chunks = local.unflatten(dst, (n, -1)).movedim(dst, 0).contiguous()
    got = wait_tensor(all_to_all_single(chunks, None, None, (mesh, i)))
    out = got.movedim(0, src).flatten(src, src + 1)
    return DTensor.from_local(out, mesh, want, run_check=False,
                              shape=t.shape, stride=t.stride())


def _moved(t, want):
    """``t`` on ``want``: by ``redistribute``, but a shard that goes from
    one tensor dim to another in one all-to-all (:func:`_all_to_all`;
    DTensor runs that move as an all-gather and a chunk on a CPU world),
    after the other mesh dims have moved."""
    from torch.distributed.tensor import Shard
    want = tuple(want)
    swaps = [i for i, (a, b) in enumerate(zip(t.placements, want))
             if type(a) is Shard and type(b) is Shard and a.dim != b.dim]
    first = tuple(t.placements[i] if i in swaps else p
                  for i, p in enumerate(want))
    if tuple(t.placements) != first:
        t = t.redistribute(placements=first)
    for i in swaps:
        moved = _all_to_all(t, i, t.placements[i].dim, want[i].dim)
        t = t if moved is None else moved
    return t if tuple(t.placements) == want else \
        t.redistribute(placements=want)


def _run_plan(plan: _Plan, x, w, cache=None):
    """The local product of ``plan`` on ``x`` and ``w`` moved to its
    placements, and its output moved on to ``plan.final``.  Returns the
    output and the local operands.  ``cache`` keeps ``x`` once moved, by
    identity, for the next product that takes it to the same place."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    hit = cache.get(x) if cache is not None else None
    if hit is not None and hit[0] == plan.x:
        xm = hit[1]
    else:
        xm = _moved(x, plan.x)
        if cache is not None:
            cache[x] = (plan.x, xm)
    xl, wl = xm.to_local(), _moved(w, plan.w).to_local()
    # a 2-D weight's product as the model writes it, ``x @ w``
    local = torch.matmul(xl, wl) if w.ndim == 2 else \
        torch.einsum(plan.eq, xl, wl)
    out = DTensor.from_local(local, x.device_mesh, plan.out, run_check=False,
                             shape=torch.Size(plan.shape),
                             stride=_contiguous_stride(plan.shape))
    reduced = [Replicate() if isinstance(p, Partial) and
               not isinstance(f, Partial) else p
               for p, f in zip(plan.out, plan.final)]
    if reduced != list(plan.out):
        out = out.redistribute(placements=reduced)
    return _moved(out, plan.final), xl, wl


def _contiguous_stride(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for d in reversed(tuple(shape)):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


class _ExpertProduct(torch.autograd.Function):
    """An expert product ``einsum(eq, x, w)`` (``"becd,edf->becf"``,
    ``"becf,efd->becd"``, ``models/ffn.py``) with a weight sharded on
    its expert dim, run on each rank's own experts, as XLA's partitioner
    runs the reference's: never DTensor's einsum strategy, which gathers
    the experts whole on the model axis (and raises on torch 2.11).

    The plan (:func:`_product_plans`) takes the activations to the
    weight's expert shard (the dispatch: one all-to-all from a shard of
    their batch; a local cut from ``Replicate``), and settles the
    weight's other sharded dim by the cost rule.  The first expert
    product that finds its activations already there ends the block (the
    combine): its output goes back to where the dispatch took them from,
    in one all-to-all.  The backward moves the output gradient to the
    local product's placements (a pending sum there replicated), runs
    ``dx`` and ``dw`` on the same shards, and moves each to its input's
    own placements (``dw``'s pending sum over the rows reduce-scattered
    onto the weight's)."""

    @staticmethod
    def forward(ctx, plan, cache, x, w):
        out, xl, wl = _run_plan(plan, x, w, cache)
        ctx.save_for_backward(xl, wl)
        ctx.plan = plan
        ctx.meta = [(t.device_mesh, tuple(t.placements), t.shape, t.stride())
                    for t in (x, w)]
        return out

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        plan = ctx.plan
        xl, wl = ctx.saved_tensors
        la, _, lo = plan.eq.partition("->")
        lx, lw = la.split(",")
        gp = _reduced_placements(plan.out)
        gl = _moved(g, gp).to_local()
        grads = []
        for (mesh, placed, shape, stride), eq, a, pa, b, pb, lg in (
                (ctx.meta[0], f"{lo},{lw}->{lx}", gl, gp, wl, plan.w, lx),
                (ctx.meta[1], f"{lx},{lo}->{lw}", xl, plan.x, gl, gp, lw)):
            la2, lb2 = eq.split("->")[0].split(",")
            d = DTensor.from_local(
                torch.einsum(eq, a, b), mesh,
                _product_placements(la2, pa, lb2, pb, lg), run_check=False,
                shape=shape, stride=stride)
            grads.append(_moved(d, placed))
        return (None, None) + tuple(grads)


def _weight_product(x, w):
    """``x @ w`` for a 2-D weight on DTensors, as XLA's partitioner runs
    it for the same rules, which moves whichever side is smaller
    (:func:`_rows_move`).  Under (W) the weight is gathered where the
    rows of ``x`` are sharded (:class:`_GatheredWeight`) and multiplied
    (:class:`_WeightProduct`).  Under (R), taken only where neither
    operand requires a gradient (a decode step's few rows against a wide
    weight), the rows move instead and the output comes back on the
    placements (W) gives it.

    DTensor left to itself picks each op's placements greedily, by the
    bytes its inputs would move.  Where a micro-batch's rows were fewer
    than a weight's, it moved the activations instead of the weight and
    split the contraction, and every model rank then ran the whole
    output width: 16x the FFN's FLOPs on the 16x16 mesh at
    ``grad_accum=8``.  torch 2.11 went further, in the backward."""
    from torch.distributed.tensor import Partial
    if not (torch.is_grad_enabled() and (x.requires_grad or
                                         w.requires_grad)) and \
            not any(isinstance(p, Partial) for p in x.placements):
        rows = "abcdefgh"[:x.ndim - 1]
        plan = _rows_move(x, w, rows + "y", "yz", rows + "z")[1]
        if plan is not None:
            return _run_plan(plan, x, w)[0]
    wg = _GatheredWeight.apply(x, w)
    return _WeightProduct.apply(wg.grad_fn, x, wg)


class _GatheredWeight(torch.autograd.Function):
    """``w`` gathered FSDP's way for its product with ``x``
    (``_gathered_weight``), saving ``x`` and the gathered weight for that
    product's backward (:class:`_WeightProduct`).  Saved here, they are
    packed before the product runs, so a checkpoint's recompute, which
    stops at the last tensor it must regenerate, stops short of a block's
    last product, as the reference's recompute does (nothing in the
    backward reads that product's output).  The backward takes the
    gathered weight's gradient, a pending sum over the rows' mesh dims,
    onto the weight's own placements (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, w):
        wg = _gathered_weight(x, w)
        if wg is w:
            wg = w.view_as(w)
        ctx.save_for_backward(x, wg)
        ctx.w_placements = tuple(w.placements)
        return wg

    @staticmethod
    def backward(ctx, g):
        return None, g.redistribute(placements=ctx.w_placements)


class _WeightProduct(torch.autograd.Function):
    """``x @ wg`` for the gathered weight of ``gather`` (the
    :class:`_GatheredWeight` node that made ``wg`` and holds both
    operands); in the backward, the output gradient moved back to the
    output's placements (a pending sum there reduced), and ``dx = g wᵀ``
    and ``dw = xᵀ g`` on those."""

    @staticmethod
    def forward(ctx, gather, x, wg):
        out = x @ wg
        ctx.gather = gather
        ctx.g_placements = _reduced_placements(out.placements)
        return out

    @staticmethod
    def backward(ctx, g):
        x, wg = ctx.gather.saved_tensors
        g = g.redistribute(placements=ctx.g_placements)
        g2 = g.reshape(-1, g.shape[-1])
        dx = torch.mm(g2, wg.t()).reshape(x.shape)
        dw = torch.mm(x.reshape(-1, x.shape[-1]).t(), g2)
        return None, dx, dw


def _placed_like(x, want):
    """``x`` on ``want`` where that splits its dims evenly and ``x`` holds
    no pending sum.  DTensor slices a sharded dim by gathering it, so a
    micro-batch cut from a batch sharded on ``data`` comes out replicated
    and every data rank would run all of it; XLA keeps the operand's
    sharding on the slice.  Going back from ``Replicate`` to ``Shard`` is
    a local chunk, so this costs the one gather of the batch."""
    from torch.distributed.tensor import Partial
    want = tuple(want)
    if tuple(x.placements) == want or any(
            isinstance(p, Partial) for p in x.placements):
        return x
    ways = [1] * x.ndim
    for i, p in enumerate(want):
        if p.is_shard():
            ways[p.dim] *= x.device_mesh.size(i)
    if any(x.shape[d] % w for d, w in enumerate(ways)):
        return x
    return x.redistribute(placements=want)


def _reduced_placements(placements):
    from torch.distributed.tensor import Partial, Replicate
    return [Replicate() if isinstance(p, Partial) else p for p in placements]


class _Reduced(torch.autograd.Function):
    """A pending sum reduced to ``Replicate``; its gradient comes back with
    any pending sum reduced too, since DTensor cannot turn a plain pending
    sum back into a lookup's masked one."""

    @staticmethod
    def forward(ctx, x):
        return x.redistribute(placements=_reduced_placements(x.placements))

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(placements=_reduced_placements(g.placements))


def _rmsnorm_rules(x, scale, eps=1e-6, impl=None
                   ) -> List[Tuple[List[Any], List[Any]]]:
    from torch.distributed.tensor import Replicate, Shard
    out = [([Replicate()], [Replicate(), Replicate(), None, None])]
    for d in range(x.ndim - 1):
        out.append(([Shard(d)], [Shard(d), Replicate(), None, None]))
    return out


def _index_copy_rules(x, dim, index, source):
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    out = [([Replicate()], [Replicate(), None, Replicate(), Replicate()])]
    for d in range(x.ndim):
        if d != dim:
            out.append(([Shard(d)], [Shard(d), None, Replicate(), Shard(d)]))
    return out


def _scatter_rules(x, dim, index, src):
    """``scatter(x, dim, index, src)``: everything replicated, or any dim
    but the written one sharded on all four where the three operands agree
    in size on it, so each rank writes its own rows locally.  torch 2.13's
    own rule; 2.11 offered only the replicated one, so the MoE dispatch
    (``models/ffn.py``: the kept pairs scattered into a fresh zero buffer,
    index and source sharded on the batch) all-gathered both and
    replicated the buffer."""
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    out = [([Replicate()], [Replicate(), None, Replicate(), Replicate()])]
    if x.ndim == index.ndim:
        for d in range(x.ndim):
            if d != dim and x.shape[d] == index.shape[d] == src.shape[d]:
                out.append(([Shard(d)], [Shard(d), None, Shard(d),
                                         Shard(d)]))
    return out


def _shards_on(t, dim: int) -> bool:
    """``t`` is a DTensor a mesh dim shards (plainly) on ``dim``."""
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(t, DTensor) and isinstance(dim, int) and any(
        type(p) is Shard and p.dim == dim % t.ndim for p in t.placements)


def _plain(t) -> bool:
    """Every placement of ``t`` is ``Replicate`` or a plain ``Shard``."""
    from torch.distributed.tensor import Replicate, Shard
    return all(type(p) is Shard or isinstance(p, Replicate)
               for p in t.placements)


def _as_dtensor(t, like):
    """``t`` as a DTensor on ``like``'s mesh (a plain tensor replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh,
                              [Replicate()] * like.device_mesh.ndim,
                              run_check=False)


def _sharded_index_copy(x, dim: int, index, source):
    """``x.index_copy(dim, index, source)`` where a mesh dim shards ``x``
    on ``dim``, the written dim (a KV or MLA cache's sequence), without
    moving ``x``: XLA's partition of a ``dynamic_update_slice`` on a
    sharded dim.  Every rank takes the new rows and the row indices whole,
    and writes the rows that fall in its own slice ``[start, start + n)``;
    the others it writes back as they were.  The local index is ``(row -
    start) mod n``: the rows a write takes are a run of at most ``n``
    (``kv_cache_update``, ``mla_cache_update``), so no two land on one
    local row, and the written cache is the unsharded write's bit for bit.
    ``start`` comes from this rank's mesh coordinate, the mask from the
    row indices on the device: nothing is read back to the host.  The
    output keeps ``x``'s placements."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing
    dim %= x.ndim
    mesh = x.device_mesh
    want = [Replicate() if type(p) is Shard and p.dim == dim else p
            for p in x.placements]
    src = _as_dtensor(source, x).redistribute(placements=want).to_local()
    rows = _as_dtensor(index, x).full_tensor()
    # ints from the shape and the coordinate; DTensor computes them on an
    # arange, which a trace would make a tensor of unbacked symbols
    with unset_fake_temporarily(), disable_proxy_modes_tracing():
        shape, offset = compute_local_shape_and_global_offset(
            tuple(int(d) for d in x.shape), mesh, x.placements)
    n, start = int(shape[dim]), int(offset[dim])
    xl = x.to_local()
    if n:
        local = torch.remainder(rows - start, n)
        mine = ((rows >= start) & (rows < start + n)).view(
            [-1 if d == dim else 1 for d in range(x.ndim)])
        xl = xl.index_copy(dim, local, torch.where(
            mine, src, xl.index_select(dim, local)))
    # DTensor's own constructor, as its ops build their outputs: from_local
    # would hand the step a view of the write, and capture returns a
    # view's base only when it is one view deep, so each layer's cache
    # would be copied again at the step's end
    spec = DTensorSpec(mesh, tuple(x.placements), tensor_meta=TensorMeta(
        x.shape, x.stride(), x.dtype))
    return DTensor(xl, spec, requires_grad=False)


def _sharded_softmax(x, dim: int, dtype=None):
    """``torch.softmax(x, dim)`` where a mesh dim shards ``x`` on ``dim``
    (decode scores over a sequence-sharded cache), reduced across the
    shards as XLA reduces a partial softmax: each rank's max, an
    all-reduce of it, ``exp`` and each rank's sum, an all-reduce of that.
    The probabilities stay sharded where ``x`` was; the two statistics are
    ``(..., 1)`` in size.  The math runs in f32 at least."""
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    out_dtype = dtype or x.dtype
    x = x.to(torch.promote_types(out_dtype, torch.float32))
    stat = [Replicate() if type(p) is Shard and p.dim == dim else p
            for p in x.placements]
    m = x.amax(dim, keepdim=True).redistribute(placements=stat)
    e = torch.exp(x - m)
    return (e / e.sum(dim, keepdim=True).redistribute(
        placements=stat)).to(out_dtype)


def _cache_product(call, a, b, la: str, lb: str, lo: str):
    """``call(a, b)``, a product written as the einsum ``la,lb->lo``, run
    where the larger operand, a cache sharded on its sequence, lies; else
    ``None`` (a product the larger operand is sharded for on no dim but
    shared batch dims, a larger one on anything but a plain ``Shard``, or
    operands that do not lead with one batch dim: a cache and its queries
    do, a weight does not, and there DTensor's own choice splits the
    work).

    DTensor picks each product's placements by its own cost model, which
    does not see that one operand is a token and the other a 32k cache: it
    gathered the cache.  Here the smaller operand moves instead: on each
    mesh dim that shards the larger on a dim, the smaller is sharded on
    its dim of the same letter, or replicated if it has none (decode's
    query, for ``q · kᵀ`` with k sharded on T).  Where that dim is summed
    over (T in ``p · v``), each rank holds a share of the sum; it is
    reduce-scattered onto the first dim after the batch that the mesh dim
    divides (the heads, where the query's heads were), so the layer goes
    on as it did with the query's heads split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    swap = a.numel() > b.numel()
    small, big, ls, lbig = (b, a, lb, la) if swap else (a, b, la, lb)
    if ls[0] != lbig[0] or not _plain(big) or any(
            ls.count(c) > 1 or (c in lbig and
                                small.shape[ls.index(c)] !=
                                big.shape[lbig.index(c)]) for c in ls):
        return None
    want, cached, summed = list(small.placements), [], []
    for i, p in enumerate(big.placements):
        if type(p) is Shard:
            c = lbig[p.dim]
            if c not in ls or c not in lo:
                cached.append(c)
            if c in ls and c not in lo:
                summed.append(i)
            want[i] = Shard(ls.index(c)) if c in ls else Replicate()
    if not cached:
        return None
    # a mesh dim that replicates both operands would have its ranks repeat
    # one product: split the cache's sequence over it as well (a local
    # slice of the replicated cache, nothing moved)
    seq = lbig.index(cached[0])
    ways = math.prod(big.device_mesh.size(i) for i, p in
                     enumerate(big.placements) if type(p) is Shard and
                     p.dim == seq)
    placed = list(big.placements)
    for i, p in enumerate(placed):
        n = big.device_mesh.size(i)
        if n > 1 and isinstance(p, Replicate) and \
                isinstance(want[i], Replicate) and \
                big.shape[seq] % (ways * n) == 0:
            placed[i], ways = Shard(seq), ways * n
            if cached[0] in ls:
                want[i] = Shard(ls.index(cached[0]))
                summed.append(i)
    big = big.redistribute(placements=placed)
    small = small.redistribute(placements=want)
    out = call(*((big, small) if swap else (small, big)))
    placed = list(out.placements)
    taken = {p.dim for p in placed if p.is_shard()}
    for i in summed:
        if not isinstance(placed[i], Partial):
            continue
        n = out.device_mesh.size(i)
        dims = [d for d in range(1, out.ndim)
                if d not in taken and out.shape[d] % n == 0]
        placed[i] = Shard(dims[0]) if dims else Replicate()
        taken.update(dims[:1])
    return out.redistribute(placements=placed)


def _matmul_letters(a, b):
    """``a @ b`` of two operands of one rank >= 3 and equal batch dims as
    einsum letters, else ``None``."""
    n = a.ndim
    if n < 3 or b.ndim != n or a.shape[:-2] != b.shape[:-2]:
        return None
    batch = "abcdefgh"[:n - 2]
    return batch + "mk", batch + "kn", batch + "mn"


def _einsum_letters(eq: str):
    """``"x,y->z"`` of a two-operand einsum, else ``None``."""
    eq = eq.replace(" ", "")
    if "->" not in eq or "." in eq:
        return None
    ins, out = eq.split("->")
    ins = ins.split(",")
    return (ins[0], ins[1], out) if len(ins) == 2 else None


def _is_expert_weight(w, lx: str, lw: str, lo: str) -> bool:
    """``w`` is a 3-D weight sharded on its leading dim, a letter the
    activations and the output share but do not lead with: an MoE
    layer's experts (a cache's products lead both operands with the
    batch)."""
    return w.ndim == 3 and len(lw) == 3 and lw[0] in lx[1:] and \
        lw[0] in lo and _shards_on(w, 0)


def _searchsorted_rules(seq, values, **kwargs):
    from torch.distributed.tensor import Replicate, Shard
    out = [([Replicate()], [Replicate(), Replicate()]),
           # every rank searches its share of the values in the whole run
           ([Shard(values.ndim - 1)], [Replicate(), Shard(values.ndim - 1)])]
    for d in range(values.ndim - 1):             # batch dims, on both
        out.append(([Shard(d)], [Shard(d), Shard(d)]))
    return out


def _pointwise_rules(n_out: int, n_in: int):
    def rules(x, *args, **kwargs):
        from torch.distributed.tensor import Replicate, Shard
        return [([p] * n_out, [p] * n_in)
                for p in [Replicate()] + [Shard(d) for d in range(x.ndim)]]
    return rules


def register_kernel_strategies() -> None:
    """Register both ops' rules with DTensor (once a process), and rules
    for five aten ops the port's models reach that DTensor lacks on torch
    2.11 or 2.13: ``index_copy`` (the KV cache's write: any dim but the
    written one sharded on the cache, the new rows and the output alike,
    the row indices replicated; torch 2.13 reaches the same function
    through a decomposition, 2.11 refuses a decode step; a cache sharded
    on the written dim never reaches the rule, ``sharded_execution``
    writes it in place), ``scatter`` with a source tensor (the MoE
    dispatch and combine: 2.13's rule, which 2.11 lacks, ``_scatter_rules``),
    ``searchsorted`` (MoE routing: batch dims on both, or the values
    alone) and ``log_sigmoid_forward`` / ``log_sigmoid_backward`` (the xLSTM
    gates; elementwise)."""
    global _REGISTERED
    if _REGISTERED:
        return
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import OpStrategy
    from torch.distributed.tensor.experimental import register_sharding

    from ..kernels import ops  # noqa: F401  (defines the ops)

    flash = torch.ops.repro_torch.flash_attention.default
    norm = torch.ops.repro_torch.rmsnorm.default
    register_sharding(flash)(_flash_rules)
    register_sharding(norm)(_rmsnorm_rules)
    aten = torch.ops.aten
    register_sharding(aten.index_copy.default)(_index_copy_rules)
    register_sharding(aten.scatter.src)(_scatter_rules)
    register_sharding(aten.searchsorted.Tensor)(_searchsorted_rules)
    register_sharding(aten.log_sigmoid_forward.default)(
        _pointwise_rules(2, 1))
    register_sharding(aten.log_sigmoid_backward.default)(
        _pointwise_rules(1, 3))

    # register_sharding expands the per-dim rules over every combination
    # of mesh dims; keep only the combinations whose head shards pair q
    # with its own kv heads
    funcs = DTensor._op_dispatcher.sharding_propagator.op_strategy_funcs
    expand = funcs[flash]

    def aligned(op_schema):
        st = expand(op_schema)
        return OpStrategy([s for s in st.strategies if _heads_aligned(s)])
    funcs[flash] = aligned
    _REGISTERED = True


@contextlib.contextmanager
def sharded_execution() -> Iterator[None]:
    """Run a step's model code on DTensors: the rules above registered,
    plain tensors the model makes (positions, masks, the iota of the loss)
    taken as replicated (``implicit_replication``), flash attention on
    inputs DTensor must move given contiguous ones (``_moved_flash``), an
    embedding lookup into a vocab-sharded table reduced at once, a slice
    of the leading dim (a micro-batch) kept on its operand's placements
    (``_placed_like``), a product with a 2-D weight moving whichever side
    is smaller (``_weight_product``: the weight gathered FSDP's way, or
    without a gradient the rows moved where that costs fewer bytes,
    ``_rows_move``), an MoE layer's expert products (a two-operand
    ``einsum`` with a 3-D weight sharded on its expert dim) on each
    rank's own experts (``_expert_product``), a pending sum reduced
    before ``log`` takes it (``_Reduced``), a cache sharded on its
    sequence written, softmaxed over and multiplied where it lies
    (``_sharded_index_copy``, ``_sharded_softmax``, ``_cache_product``:
    ``index_copy`` on the sharded dim, ``softmax`` over it, and a batched
    ``matmul`` or a two-operand ``einsum`` whose larger operand is so
    sharded), and three of DTensor's own steps adjusted for a traced step
    (``_untraced_meta``, ``_host_strided_offsets``,
    ``_resharding_views``).

    ``log``: the loss's ``log(sum(exp(x)))`` over vocab-sharded logits
    takes a pending sum.  ``log``'s backward divides by its saved input,
    and autograd saves the pending sum itself, not DTensor's reduction of
    it; torch 2.11's DTensor divided by the local share, so the gradients
    were wrong on a real multi-rank world (2.13 gets it right).  Reduced
    first, ``log`` saves the whole sum on every version.

    DTensor computes that lookup as a masked local gather whose output is
    a pending sum (``_MaskPartial``) that holds its mask until the one
    reduction; the first hidden state has two readers (the first norm and
    the residual), and the second would find the mask gone.  Reducing it
    to ``Replicate`` where it is made is one all-reduce of the (B, S, D)
    activations, the collective XLA's partitioner emits for the same
    gather."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.distributed.tensor.placement_types import _MaskPartial
    from torch.overrides import TorchFunctionMode
    from torch.utils.weak import WeakIdKeyDictionary

    register_kernel_strategies()
    flash = torch.ops.repro_torch.flash_attention.default
    # expert activations once dispatched, and where each dispatch took
    # them from (``_expert_product``)
    moved, dispatched = WeakIdKeyDictionary(), {}

    class _ShardedOps(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is flash and isinstance(args[0], DTensor):
                if not _ready(*args[:3]):
                    return _moved_flash(func, args, kwargs)
                return _LocalFlash.apply(func, kwargs, *args)
            if func in (torch.Tensor.matmul, torch.matmul) and \
                    not kwargs and len(args) == 2 and \
                    isinstance(args[0], DTensor) and \
                    isinstance(args[1], DTensor) and args[1].ndim == 2:
                return _weight_product(*args)
            if func in (torch.Tensor.index_copy, torch.index_copy) and \
                    not kwargs and len(args) == 4 and \
                    _shards_on(args[0], args[1]) and _plain(args[0]) and \
                    not (args[0].requires_grad or args[3].requires_grad) and \
                    args[2].numel() <= args[0].to_local().shape[args[1]]:
                return _sharded_index_copy(*args)
            if func in (torch.softmax, torch.Tensor.softmax) and \
                    _shards_on(args[0], args[1] if len(args) > 1 else
                               kwargs.get("dim")):
                return _sharded_softmax(*args, **kwargs)
            if func in (torch.Tensor.matmul, torch.matmul) and \
                    not kwargs and len(args) == 2 and \
                    isinstance(args[0], DTensor) and \
                    isinstance(args[1], DTensor):
                letters = _matmul_letters(*args)
                out = letters and _cache_product(func, *args, *letters)
                if out is not None:
                    return out
            if func is torch.einsum and len(args) == 3 and \
                    isinstance(args[1], DTensor) and \
                    isinstance(args[2], DTensor):
                letters = _einsum_letters(args[0])
                if letters and _is_expert_weight(args[2], *letters):
                    return _expert_product(*args[1:], *letters, moved,
                                           dispatched)
                out = letters and _cache_product(
                    lambda x, y: func(args[0], x, y), *args[1:], *letters)
                if out is not None:
                    return out
            if func in (torch.log, torch.Tensor.log) and \
                    isinstance(args[0], DTensor) and any(
                        isinstance(p, Partial) for p in args[0].placements):
                args = (_Reduced.apply(args[0]),) + tuple(args[1:])
            out = func(*args, **kwargs)
            if func is F.embedding and isinstance(out, DTensor) and any(
                    isinstance(p, _MaskPartial) for p in out.placements):
                out = _Reduced.apply(out)
            if func is torch.Tensor.__getitem__ and \
                    isinstance(args[1], slice) and \
                    isinstance(args[0], DTensor):
                out = _placed_like(out, args[0].placements)
            return out

    with implicit_replication(), _ShardedOps(), _host_strided_offsets(), \
            _resharding_views(), _untraced_meta():
        yield


@contextlib.contextmanager
def _untraced_meta() -> Iterator[None]:
    """DTensor derives an op's global output shape by running the op on
    fake global-shape arguments.  torch 2.11 does that under the capture's
    tracer, so every such op left dead "shadow" nodes in the graph: an
    ``empty_strided`` on the CPU and the op on it (the plan then ran an
    embedding on uninitialised indices).  torch 2.13 runs it untraced;
    this does the same on 2.11."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

    orig = ShardingPropagator.__dict__.get("_propagate_tensor_meta_non_cached")
    if orig is None:
        yield
        return

    def untraced(self, op_schema):
        with disable_proxy_modes_tracing():
            return orig(self, op_schema)
    ShardingPropagator._propagate_tensor_meta_non_cached = untraced
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _strict_first(strict, loose):
    def rule(op_schema):
        try:
            return strict(op_schema)
        except RuntimeError:
            return loose(op_schema)
    return rule


@contextlib.contextmanager
def _resharding_views() -> Iterator[None]:
    """DTensor refuses a ``view`` that splits a dim whose shards do not
    fall on whole pieces of the split (``gemma_2b``'s 8 heads of a q
    projection sharded 16 ways, forward and backward); XLA reshards
    there, and so does this: ``view`` and ``_unsafe_view`` take DTensor's
    ``reshape`` rule, which gathers such a dim first.  The step is
    functional, so a view that is a copy of its input changes nothing.
    Every view DTensor takes as it is keeps its own rule."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops import _view_ops

    prop = DTensor._op_dispatcher.sharding_propagator
    ops = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)
    saved = [(prop.op_strategy_funcs.get(op), prop.op_to_schema_info.get(op))
             for op in ops]
    for op, (strict, _) in zip(ops, saved):
        _view_ops.register_op_strategy_map(
            op, torch.Tensor.view, schema_info=RuntimeSchemaInfo(1),
            strict_view=False)
        prop.op_strategy_funcs[op] = _strict_first(
            strict, prop.op_strategy_funcs[op])
    try:
        yield
    finally:
        for op, (fn, info) in zip(ops, saved):
            prop.op_strategy_funcs[op] = fn
            prop.op_to_schema_info[op] = info


@contextlib.contextmanager
def _host_strided_offsets() -> Iterator[None]:
    """DTensor finds a strided shard's local size and offsets
    (``_StridedShard.local_shard_size_and_offset``, met where a product
    merges a dim sharded on one mesh dim with one sharded on another: the
    batch on ``data`` with the heads on ``model``) by splitting an
    ``arange`` over the dim and reading it back with ``tolist``.  Under a
    trace that tensor is fake: every element becomes a fresh unbacked
    symbol, tens of thousands of them at a 32k cache, and a cell takes
    minutes.  The function reads only ints, so it runs here outside the
    trace, on a real ``arange``."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

    cls = getattr(pt, "_StridedShard", None)
    raw = vars(cls).get("local_shard_size_and_offset") if cls else None
    if raw is None:
        yield
        return
    static = isinstance(raw, staticmethod)
    fn = raw.__func__ if static else raw

    def on_host(*args, **kwargs):
        with unset_fake_temporarily(), disable_proxy_modes_tracing():
            return fn(*args, **kwargs)
    cls.local_shard_size_and_offset = staticmethod(on_host) if static \
        else on_host
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = raw
