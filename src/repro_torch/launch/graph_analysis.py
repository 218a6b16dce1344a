"""Static FLOP and byte count of a captured step, with loop trip counts.

Port of ``repro/launch/hlo_analysis.py`` (``HLOAnalyzer``,
``analyze_hlo``).  The reference parses XLA's optimized HLO; the port
reads its own captured ``Graph`` -- what the planner plans, the port's
stand-in for optimized HLO -- at a concrete binding ``env`` of its
symbolic dims, and returns the reference's keys:

  * ``flops`` -- 2·M·N·K of every ``mm``/``bmm``/``addmm``/``baddbmm``/
    ``matmul``/``linear``/``convolution``; ``repro_torch::flash_attention``
    counts the dense math of its function, 2·B·Hq·S·T·(hd_qk + hd_v)
    (4·B·Hq·S·T·hd), which is what the reference's model computes at
    T <= 2048 (``repro/models/attention.py:220-232``), so the count is the
    same whatever implements the op;
  * ``hbm_bytes`` -- operand + result bytes of every node that is not a
    view (a view's operand is read at its own size).  The port runs every
    node as its own op and fuses nothing, so this is the traffic of an
    unfused step and differs by design from XLA's fusion-aware count;
  * ``transcendentals`` -- output elements of exp/log/tanh/rsqrt/sqrt/
    pow/sigmoid/sin/cos, plus the exps of flash attention's softmax
    (B·Hq·S·T) and the rsqrt of each RMSNorm row;
  * the five collective types, ``collective_bytes`` -- the output bytes
    of every functional collective (``_c10d_functional::*``, what DTensor
    emits when a step runs sharded): ``all_gather_into_tensor`` as
    ``all-gather``, ``all_reduce`` as ``all-reduce``,
    ``reduce_scatter_tensor`` as ``reduce-scatter``, ``all_to_all_single``
    as ``all-to-all`` (funcol's ``permute_tensor`` lowers to it too), the
    point-to-point ``isend``/``irecv``/``batch_p2p_ops`` as
    ``collective-permute``, and their ``_coalesced`` forms likewise.
    ``wait_tensor`` counts 0, as the reference's ``-done`` half does
    (``repro/launch/dryrun.py:68-69``).  A one-card graph has none;
  * ``n_warnings`` -- see ``GraphAnalyzer.warnings``.

Loops.  A rolled ``Loop`` node's body is counted once and scaled by its
trip count at ``env``; an opaque scan's captured fx body by its length;
nested loops multiply (the reference's ``trip_count``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from ..core.ir.capture import Arg, _is_view_op
from ..core.ir.graph import Graph, Node
from ..core.ir.loop import OpaqueScan, loop_body_of
from ..core.symbolic import SymbolicExpr

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# op (overload packet) -> index of the left operand whose last dim is K
_MATMULS = {"mm": 0, "bmm": 0, "matmul": 0, "addmm": 1, "baddbmm": 1,
            "linear": 0}
# functional collective -> the reference's collective type
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "isend": "collective-permute", "irecv": "collective-permute",
                "batch_p2p_ops": "collective-permute"}
_TRANSCENDENTAL = {"exp", "log", "tanh", "rsqrt", "sqrt", "pow", "sigmoid",
                   "sin", "cos"}


class _T:
    """An operand or result: its concrete shape and dtype."""
    __slots__ = ("shape", "dtype", "view")

    def __init__(self, shape: Sequence[int], dtype: torch.dtype,
                 view: bool = False):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.view = view

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.numel * self.dtype.itemsize


def _op_name(prim: Any) -> Tuple[str, str]:
    """(namespace, op) of an ``OpOverload``: ``("aten", "mm")``."""
    name = getattr(prim, "_schema", None)
    name = name.name if name is not None else str(prim)
    ns, _, op = name.partition("::")
    return (ns, op) if op else ("", ns)


def _zero() -> Dict[str, float]:
    return {"flops": 0.0, "hbm_bytes": 0.0, "transcendentals": 0.0,
            **{c: 0.0 for c in COLLECTIVE_OPS}}


def _add(tot: Dict[str, float], sub: Dict[str, float], k: float) -> None:
    for key, v in sub.items():
        tot[key] += v * k


def op_costs(prim: Any, args: Sequence[Any], outs: Sequence[_T]
             ) -> Dict[str, float]:
    """FLOPs, bytes and transcendentals of one op; ``args`` are its
    positional arguments with tensors as :class:`_T`."""
    ns, op = _op_name(prim)
    tot = _zero()
    ins = [a for a in args if isinstance(a, _T)]
    if ns == "aten" and op in _MATMULS and len(ins) > _MATMULS[op]:
        k = ins[_MATMULS[op]].shape[-1]
        tot["flops"] = 2.0 * sum(o.numel for o in outs) * k
    elif ns == "aten" and op == "convolution" and len(ins) >= 2:
        w = ins[1].shape
        tot["flops"] = 2.0 * sum(o.numel for o in outs) * \
            w[1] * math.prod(w[2:])
    elif ns == "repro_torch" and op == "flash_attention":
        q, k, v = ins[:3]
        b, hq, s, hd = q.shape
        t = k.shape[2]
        tot["flops"] = 2.0 * b * hq * s * t * (hd + v.shape[-1])
        tot["transcendentals"] = float(b * hq * s * t)
    elif ns == "repro_torch" and op == "rmsnorm":
        x = ins[0]
        tot["transcendentals"] = float(x.numel // max(x.shape[-1], 1)
                                       if x.shape else 1)
    elif ns == "_c10d_functional" and op in _COLLECTIVES:
        tot[_COLLECTIVES[op]] = float(sum(o.nbytes for o in outs))
    if ns == "aten" and op in _TRANSCENDENTAL:
        tot["transcendentals"] = float(sum(o.numel for o in outs))
    tot["hbm_bytes"] = float(sum(o.nbytes for o in outs) +
                             sum(i.nbytes for i in ins))
    return tot


class GraphAnalyzer:
    """Counts of a captured ``Graph`` at one binding of its dims.

    ``warnings``: a bounded dim ``env`` does not bind (counted at its
    cap), or an opaque body whose shapes are symbolic (counted at the
    capture's example sizes).  ``largest``: per collective type, the
    output bytes of its largest single node (0 for a type the graph lacks),
    filled by ``analyze``."""

    def __init__(self, graph: Graph, env: Optional[Mapping[str, int]] = None):
        self.graph = graph
        self.env = dict(env or {})
        self.warnings: List[str] = []
        self.largest: Dict[str, int] = dict.fromkeys(COLLECTIVE_OPS, 0)
        for name, cap in graph.bound_dims.items():
            if name not in self.env:
                self.env[name] = cap.evaluate(self.env)
                self.warnings.append(f"bounded dim {name} not in env: "
                                     f"counted at its cap {self.env[name]}")

    # -- the port's Graph --------------------------------------------------------
    def _value(self, v) -> _T:
        return _T((d.evaluate(self.env) for d in v.dims), v.dtype,
                  view=v.base is not None)

    def _args(self, n: Node) -> List[Any]:
        """The node's positional and keyword arguments, tensors as _T."""
        leaves = [self._value(n.invals[x.i]) if isinstance(x, Arg) else
                  x.evaluate(self.env) if isinstance(x, SymbolicExpr) else x
                  for x in n.params["leaves"]]
        args, kwargs = pytree.tree_unflatten(leaves, n.params["spec"])
        return list(pytree.tree_leaves((args, kwargs),
                                       is_leaf=lambda x: isinstance(x, _T)))

    def totals(self, graph: Graph) -> Dict[str, float]:
        tot = _zero()
        for n in graph.nodes:
            body = loop_body_of(n)
            if body is not None:
                _add(tot, self.totals(body.graph),
                     body.length_expr.evaluate(self.env))
                continue
            outs = [self._value(o) for o in n.outvals]
            if isinstance(n.prim, OpaqueScan):
                (_, xs, _), _ = pytree.tree_unflatten(n.params["leaves"],
                                                      n.params["spec"])
                trips = n.invals[xs[0].i].dims[0].evaluate(self.env)
                _add(tot, self._fx_totals(n.prim.body), trips)
                continue
            if outs and all(o.view for o in outs):
                continue
            costs = op_costs(n.prim, self._args(n), outs)
            for c in COLLECTIVE_OPS:
                self.largest[c] = max(self.largest[c], int(costs[c]))
            _add(tot, costs, 1.0)
        return tot

    # -- an opaque scan's fx body ------------------------------------------------
    def _fx_tensor(self, x: Any) -> Any:
        import torch.fx
        val = x.meta.get("val") if isinstance(x, torch.fx.Node) else x
        if not isinstance(val, torch.Tensor):
            return val
        shape = []
        for d in val.shape:
            if not isinstance(d, int):
                self.warnings.append(f"opaque scan body with symbolic size "
                                     f"{d}: counted at its example size")
            shape.append(int(d))
        return _T(shape, val.dtype, view=False)

    def _fx_totals(self, gm: Any) -> Dict[str, float]:
        tot = _zero()
        for node in gm.graph.nodes:
            if node.op != "call_function":
                continue
            target = node.target
            if target is torch.ops.higher_order.scan or \
                    getattr(target, "__name__", "") == "_run_scan":
                sub = getattr(gm, node.args[0].target)
                trips = self._fx_tensor(node.args[2][0]).shape[0]
                _add(tot, self._fx_totals(sub), trips)
                continue
            if not isinstance(target, torch._ops.OpOverload):
                continue
            val = node.meta.get("val")
            vals = val if isinstance(val, (tuple, list)) else [val]
            if _is_view_op(target):
                continue
            outs = [self._fx_tensor(v) for v in vals
                    if isinstance(v, torch.Tensor)]
            args = [self._fx_tensor(a) for a in pytree.tree_leaves(
                (node.args, node.kwargs))]
            _add(tot, op_costs(target, args, outs), 1.0)
        return tot

    def analyze(self) -> Dict[str, float]:
        out = self.totals(self.graph)
        out["collective_bytes"] = sum(out[c] for c in COLLECTIVE_OPS)
        out["n_warnings"] = float(len(self.warnings))
        return out


def analyze_graph(graph: Graph, env: Optional[Mapping[str, int]] = None
                  ) -> Dict[str, float]:
    """``GraphAnalyzer(graph, env).analyze()``."""
    return GraphAnalyzer(graph, env).analyze()
