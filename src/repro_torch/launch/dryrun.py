"""Multi-pod dry-run: trace and plan every (arch x input-shape x mesh) cell.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell's jitted step over ``ShapeDtypeStruct``s sharded on a 16x16 or
2x16x16 mesh of 512 forced host devices, and reads XLA's memory and cost
analysis and the collectives of the optimized HLO.  The port runs the
same cell as one rank of a fake process group (``init_fake_world(512)``,
where collectives move nothing):

1. the specs of ``launch.specs.input_specs`` and the placements of
   ``ShardingRules`` (``params_pspecs`` / ``batch_specs`` /
   ``cache_specs``, through ``placements``) give each leaf's local shape
   on this rank;
2. the step (``make_train_step(cfg, grad_accum=...)``,
   ``make_prefill_step`` or ``make_serve_step``) is captured as a function
   of the local tensors: each is wrapped with ``DTensor.from_local`` at its
   global shape, the step runs on the DTensors under
   ``strategies.sharded_execution`` and the outputs come back as local
   tensors.  The captured per-rank graph holds the local ops and the
   functional collectives DTensor emits (``_c10d_functional::*``).  That
   capture is the "lower" (``lower_s``);
3. the port's pipeline plans the graph (schedule, remat search, memory
   plan), donating the parameters and optimizer state of a train step and
   the cache of a decode step, as the reference's ``donate_argnums``.  That
   plan is the "compile" (``compile_s``).

A train step returns its parameters and moments on the placements it took
them at (redistributed where the step's own propagation left them
elsewhere), and a decode step its cache, so a step's outputs are the next
step's inputs; any pending sum (``Partial``) is reduced.

The record has the reference's keys:

* ``memory.argument_bytes`` -- the local shards' bytes, exact
  (:func:`argument_bytes` gives it without tracing);
  ``memory.output_bytes`` -- the local outputs' bytes;
  ``memory.temp_bytes`` -- the plan's peak of the values that are neither
  arguments nor outputs, along its schedule; ``total_per_device_bytes``
  their sum, as the reference's (an upper bound on the plan's peak);
  ``memory.generated_code_bytes`` -- 0: the port generates no code (its
  CUDA kernels build once a process, not a cell);
* ``flops`` / ``bytes_accessed`` / ``cost`` -- ``launch.graph_analysis``'s
  count of the per-rank graph (``flops``, ``hbm_bytes``,
  ``transcendentals``), the port's cost analysis;
* ``collectives`` -- per type, the output bytes of the graph's functional
  collectives, and ``total`` (``graph_analysis``; the dry-run's graphs put
  no collective inside a loop, so this is the reference's unscaled count);
  ``collectives_largest`` -- the port's own key: per type, the output
  bytes of the largest single collective (a cache moved whole shows here);
* ``scaled`` / ``scaled_warnings`` -- ``analyze_graph`` and its warnings,
  as the reference's ``HLOAnalyzer``;
* ``hlo_bytes`` -- the captured graph's node count, the nearest port
  quantity to the size of the HLO text;
* ``sharding_fallbacks``, ``lower_s``, ``compile_s``, ``status``;
  ``compile_spans_s``, the plan's seconds by phase (the scheduler's cost
  grows with the square of the node count, and a full-width train cell
  unrolls 8 micro-batches); ``memory.how``: what the memory figures were
  read from.

Usage (CPU, no card; the fake world is started by ``main``)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from ..configs import ARCHS, cells_for, get_config
from ..configs.base import SHAPES, ModelConfig
from ..core.ir.capture import TensorSpec, tree_flatten, tree_unflatten
from .graph_analysis import COLLECTIVE_OPS, GraphAnalyzer
from .mesh import destroy_world, init_fake_world, make_production_mesh
from .sharding import PartitionSpec, ShardingRules
from .specs import input_specs
from .steps import make_prefill_step, make_serve_step, make_train_step
from .strategies import _contiguous_stride, sharded_execution

WORLD = 512          # ranks of the fake world: the 2x16x16 mesh's
DEFAULT_OUT = "build/dryrun"     # listed in .gitignore


def _spec_leaves(spec_tree: Any) -> List[PartitionSpec]:
    """The specs of a rules tree, its Nones dropped (as ``tree_flatten``
    drops the data tree's)."""
    return [s for s in pytree.tree_leaves(
        spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
        if s is not None]


def _cell_args(kind: str, specs: Dict[str, Any], rules: ShardingRules
               ) -> Tuple[Tuple[Any, ...], Tuple[Any, ...], Tuple[int, ...]]:
    """The step's positional argument trees, each one's spec tree, and the
    donated argument positions (the reference's ``donate_argnums``)."""
    if kind == "train":
        return ((specs["params"], specs["opt_state"], specs["batch"]),
                (rules.params_pspecs(specs["params"]),
                 rules.params_pspecs(specs["opt_state"]),
                 rules.batch_specs(specs["batch"])), (0, 1))
    if kind == "prefill":
        return ((specs["params"], specs["batch"]),
                (rules.params_pspecs(specs["params"]),
                 rules.batch_specs(specs["batch"])), ())
    return ((specs["params"], specs["state"], specs["inp"]),
            (rules.params_pspecs(specs["params"]),
             rules.cache_specs(specs["state"]),
             rules.batch_specs(specs["inp"])), (1,))


def _local_shape(shape, mesh, placements) -> Tuple[int, ...]:
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return tuple(compute_local_shape_and_global_offset(
        tuple(shape), mesh, placements)[0])


def _nbytes(spec: TensorSpec) -> int:
    return math.prod(spec.shape) * spec.dtype.itemsize


def argument_bytes(cfg: ModelConfig, shape_name: str,
                   rules: ShardingRules,
                   cell: Optional[Tuple[str, Dict[str, Any]]] = None) -> int:
    """The cell's per-rank argument bytes: each leaf of ``input_specs`` at
    its local shape under ``rules``, without tracing.  ``cell``: the
    cell's ``(kind, specs)``, if at hand."""
    kind, specs = cell if cell is not None else input_specs(cfg, shape_name)
    trees, spec_trees, _ = _cell_args(kind, specs, rules)
    total = 0
    for tree, st in zip(trees, spec_trees):
        leaves, _ = tree_flatten(tree)
        for leaf, spec in zip(leaves, _spec_leaves(st)):
            local = _local_shape(leaf.shape, rules.mesh,
                                 rules.placements(spec))
            total += math.prod(local) * leaf.dtype.itemsize
    return total


@dataclass
class ShardedStep:
    """A step as a function of one rank's local tensors.

    ``fn(*args)`` takes the local-tensor pytrees ``specs`` describes and
    returns local tensors; ``dtensor_fn`` the same step's outputs as
    DTensors (their ``full_tensor()`` is the unsharded step's, on a real
    world).  ``donate``: the donated argument positions; ``placements``:
    each argument leaf's, in ``tree_flatten`` order."""
    fn: Callable
    dtensor_fn: Callable
    specs: Tuple[Any, ...]
    donate: Tuple[int, ...]
    argument_bytes: int
    mesh: Any
    placements: List[Tuple[Any, ...]]

    def shard_args(self, *args) -> Tuple[Any, ...]:
        """This rank's local shards of the full argument trees ``args``
        (every rank holds the same full tensors, so nothing moves)."""
        from torch.distributed.tensor import distribute_tensor
        leaves, tdef = tree_flatten(tuple(args))
        return tuple(tree_unflatten(
            [distribute_tensor(t, self.mesh, p, src_data_rank=None)
             .to_local() for t, p in zip(leaves, self.placements)], tdef))


def shard_step(cfg: ModelConfig, kind: str, specs: Dict[str, Any],
               rules: ShardingRules, *, grad_accum: int = 8) -> ShardedStep:
    """The ``kind`` step (``train`` / ``prefill`` / ``decode``) of
    ``cfg`` over ``specs`` (``input_specs``' trees, or any of the same
    layout), sharded by ``rules`` on its mesh."""
    from torch.distributed.tensor import DTensor

    mesh = rules.mesh
    trees, spec_trees, donate = _cell_args(kind, specs, rules)
    if kind == "train":
        step = make_train_step(cfg, grad_accum=grad_accum)
    elif kind == "prefill":
        step = make_prefill_step(cfg)
    else:
        step = make_serve_step(cfg)
    flat, tdef = tree_flatten(tuple(trees))
    placements = [rules.placements(s) for st in spec_trees
                  for s in _spec_leaves(st)]
    assert len(flat) == len(placements), (len(flat), len(placements))
    local = [TensorSpec(_local_shape(s.shape, mesh, p), s.dtype)
             for s, p in zip(flat, placements)]
    # output -> argument it replaces, which it must come back placed as:
    # the params and moments of a train step, the cache of a decode step
    returns = {"train": {1: 0, 2: 1}, "decode": {1: 1}}.get(kind, {})

    def dtensor_fn(*args):
        leaves, _ = tree_flatten(tuple(args))
        ds = [DTensor.from_local(t, mesh, p, run_check=False,
                                 shape=torch.Size(s.shape),
                                 stride=_contiguous_stride(s.shape))
              for t, s, p in zip(leaves, flat, placements)]
        dargs = tree_unflatten(ds, tdef)
        with sharded_execution():
            out = step(*dargs)
            outs = list(out) if isinstance(out, tuple) else [out]
            for i, o in enumerate(outs):
                src = returns.get(i)
                olv, otree = tree_flatten(o)
                want = tree_flatten(dargs[src])[0] if src is not None \
                    else [None] * len(olv)
                outs[i] = tree_unflatten(
                    [_placed(x, w) for x, w in zip(olv, want)], otree)
        return tuple(outs) if isinstance(out, tuple) else outs[0]

    def fn(*args):
        out = dtensor_fn(*args)
        return pytree.tree_map_only(DTensor, lambda d: d.to_local(), out)

    local_tree = tree_unflatten(local, tdef)
    return ShardedStep(fn=fn, dtensor_fn=dtensor_fn,
                       specs=tuple(local_tree), donate=donate,
                       argument_bytes=sum(_nbytes(s) for s in local),
                       mesh=mesh, placements=placements)


def _placed(x: Any, like: Any) -> Any:
    """``x`` on ``like``'s placements (the argument it replaces), else with
    every pending sum reduced."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor):
        return x
    want = tuple(like.placements) if like is not None else tuple(
        Replicate() if isinstance(p, Partial) else p for p in x.placements)
    return x if tuple(x.placements) == want else \
        x.redistribute(placements=want)


def temp_peak_bytes(graph, order) -> int:
    """The peak, along ``order``, of the bytes held by values that are
    neither the graph's inputs nor its outputs (XLA's "temp"): each is
    live from its producer to its last reader; one nothing reads is
    live for its producer's step alone."""
    from ..core.ir.loop import loop_body_of
    outputs = {v.id for v in graph.outputs}
    pos = {n.id for n in order}
    left = {v.id: sum(1 for c in v.consumers if c.id in pos)
            for v in graph.values}
    live = peak = 0
    for n in order:
        if loop_body_of(n) is not None:
            raise NotImplementedError(
                "a rolled loop in a dry-run graph: its cells are static")
        made = [v for v in n.outvals if v.id not in outputs]
        step = sum(v.nbytes_expr.evaluate({}) for v in made)
        peak = max(peak, live + step)
        live += sum(v.nbytes_expr.evaluate({}) for v in made
                    if left[v.id])
        for v in set(n.invals):
            left[v.id] -= sum(1 for x in n.invals if x is v)
            if left[v.id] == 0 and v.kind == "intermediate" and \
                    v.id not in outputs:
                live -= v.nbytes_expr.evaluate({})
    return peak


def plan_step(sharded: ShardedStep, *, device: Any = "cpu"):
    """The per-rank plan of ``sharded`` (``optimize`` of its ``fn`` at the
    local specs, inputs donated if the step donates any)."""
    from ..core.api import optimize
    return optimize(sharded.fn, *sharded.specs, device=device,
                    donate_inputs=bool(sharded.donate))


def memory_of(plan, arg_bytes: int) -> Dict[str, Any]:
    """The reference's memory analysis of a per-rank plan."""
    g = plan.plan.graph
    out = sum(v.nbytes_expr.evaluate({}) for v in {v.id: v for v in
                                                   g.outputs}.values())
    temp = temp_peak_bytes(g, plan.plan.order)
    return {"argument_bytes": arg_bytes, "output_bytes": out,
            "temp_bytes": temp, "generated_code_bytes": 0,
            "total_per_device_bytes": arg_bytes + temp + out,
            "how": "arguments: the local shards; temp: the planned "
                   "schedule's peak of non-argument, non-output values"}


def analysis_of(plan) -> Dict[str, Any]:
    """``flops``, ``bytes_accessed``, ``cost``, ``collectives``,
    ``collectives_largest``, ``scaled`` and ``scaled_warnings`` of a
    per-rank plan."""
    an = GraphAnalyzer(plan.plan.graph, {})
    scaled = an.analyze()
    coll = {c: int(scaled[c]) for c in COLLECTIVE_OPS}
    coll["total"] = sum(coll.values())
    return {"cost": {"flops": scaled["flops"],
                     "bytes accessed": scaled["hbm_bytes"],
                     "transcendentals": scaled["transcendentals"]},
            "flops": scaled["flops"], "bytes_accessed": scaled["hbm_bytes"],
            "collectives": coll, "collectives_largest": dict(an.largest),
            "scaled": {k: float(v) for k, v in scaled.items()},
            "scaled_warnings": len(an.warnings)}


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             compile_cell: bool = True, grad_accum: int = 8,
             mesh: Any = None) -> Dict[str, Any]:
    """One cell's record (``repro/launch/dryrun.py`` ``run_cell``), as rank
    0 of the current (fake) world; ``mesh`` overrides the production one
    (and names the record's mesh)."""
    cfg = get_config(arch)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": mesh_name(multi_pod) if mesh is None else
        "x".join(map(str, mesh.shape)),
        "params": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
    }
    skip = dict(cells_for(cfg))[shape_name].get("skip")
    if skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = skip
        return rec

    t0 = time.time()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rules = ShardingRules(mesh)
    kind, specs = input_specs(cfg, shape_name)
    rec["grad_accum"] = grad_accum if kind == "train" else None
    sharded = shard_step(cfg, kind, specs, rules, grad_accum=grad_accum)
    if not compile_cell:
        from ..core.ir.capture import capture
        capture(sharded.fn, sharded.specs, device=torch.device("cpu"))
        rec["lower_s"] = round(time.time() - t0, 2)
        rec["status"] = "lowered"
        return rec
    setup_s = time.time() - t0
    plan = plan_step(sharded)
    rec["lower_s"] = round(
        setup_s + plan.trace.find("trace")[0].duration_ns / 1e9, 2)
    rec["compile_s"] = round(plan.report.compile_s, 2)
    rec["compile_spans_s"] = {
        sp.name: round(sp.duration_ns / 1e9, 2) for sp in plan.trace.spans()
        if sp.name in ("schedule", "exchange", "remat", "memplan",
                       "kernel-select")}
    rec["memory"] = memory_of(plan, sharded.argument_bytes)
    rec.update(analysis_of(plan))
    rec["hlo_bytes"] = len(plan.plan.graph.nodes)
    rec["sharding_fallbacks"] = dict(rules.fallbacks)
    rec["status"] = "ok"
    return rec


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = [a for a in ARCHS if a != "llama2_1b"] \
        if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    init_fake_world(WORLD)
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    _one(arch, shape, mp, args)
    finally:
        destroy_world()


def _one(arch: str, shape: str, mp: bool, args) -> None:
    tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
    path = os.path.join(args.out, tag + ".json")
    if args.skip_existing and os.path.exists(path):
        print(f"[skip existing] {tag}")
        return
    print(f"[dryrun] {tag} ...", flush=True)
    try:
        rec = run_cell(arch, shape, multi_pod=mp)
    except Exception as e:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name(mp),
               "status": "error", "error": str(e),
               "traceback": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    status = rec.get("status")
    extra = ""
    if status == "ok":
        mem = rec.get("memory", {}).get("total_per_device_bytes")
        sc = rec.get("scaled", {})
        extra = (f" mem/dev={mem/2**30:.2f}GiB" if mem else "") + \
            f" flops={sc.get('flops', 0):.3e}" + \
            f" hbm={sc.get('hbm_bytes', 0)/2**30:.1f}GiB" + \
            f" coll={sc.get('collective_bytes', 0)/2**30:.2f}GiB"
    print(f"[done] {tag}: {status}{extra}", flush=True)


if __name__ == "__main__":
    main()
