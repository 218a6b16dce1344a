"""Symbolic capture of a PyTorch step into a ``Graph`` (the paper's "dynamic
shape computation graph").

The step is traced once with ``make_fx(..., tracing_mode="symbolic")`` over
FakeTensors made beforehand in one ``ShapeEnv`` (make_fx adopts their fake
mode instead of making every dim of every input a symbol, and the
symbolic mode's Python dispatcher routes composite ops such as ``matmul``
through size-symbolic decompositions):

* each *declared* dim name (``symbolic_dims("b, s")``) becomes one
  ``DimDynamic.DYNAMIC`` symbol, shared by every input that names it, so
  ``tokens`` and ``labels`` agree on ``b`` and ``s`` by construction;
* every other dim is a plain int, so weights stay static;
* the ShapeEnv's own symbol names (``s26``...) are renamed back to the
  user's names when sizes are converted to ``SymbolicExpr``.

ShapeEnv ranges start at 2 (sizes 0 and 1 are specialised), so each symbol
is traced at a hint >= 2 chosen inside its declared range, distinct from
the other dims' hints (duck sizing is off).  The trace must not specialise
a declared dim: if the ShapeEnv pinned one to a constant, ``capture``
raises instead of returning a graph that only holds at the example size.
A call at ``b=1`` then runs the same graph, since every aten op in it is
defined for any size.

The fx graph is converted node by node (see ``ir.graph`` for how views and
shape arithmetic are counted).  Each op node keeps its argument structure
as a flat template whose leaves are constants, ``SymbolicExpr`` sizes
(resolved per call) or references to the node's tensor inputs.

Two node kinds get more than a template:

* **bounded-dim introducers** (``ir.dynamism``): the op's fake gives its
  payload an unbacked size ``u<k>``; capture renames it to the bound
  symbol ``__b<k>`` (in introduction order) with the cap read off the
  introducer's input, and torch's fake tensors carry it through every
  consumer (``mm``, ``tanh``, ``cumsum``...).  An op that equates a bound
  dim with a full-extent dim (``rows + x``) makes the ShapeEnv replace
  ``u<k>`` by that dim; tight tensors would then meet at run time, so
  capture raises instead.  An introducer whose input carries a bound dim
  gets that dim's declared extent as its ``pad_to`` argument: it pads the
  tight input with zeros to that length, which is what the reference's
  op sees there.
* **rolled loops** (``ir.loop``): a ``torch.ops.higher_order.scan`` whose
  ``xs`` have a symbolic length becomes one loop node, its body converted
  once (with the outer dim names) into a sub-``Graph``.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import torch
from torch.utils import _pytree as pytree

from ..symbolic import SymbolicExpr
from ..symbolic.expr import Atom
from ..symbolic.from_torch import dim_to_expr, parse_range_spec
from .dynamism import BoundIntro, introduces_dim
from .graph import Graph, Value
from .loop import LOOP_PARAM, LoopBody, rollable_body

_CLONE = torch.ops.aten.clone.default
# ops that return their input's storage without the schema marking an alias
_STORAGE_ALIASES = (torch.ops.aten._unsafe_view.default,)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SymDim:
    """A named symbolic dimension usable inside ``TensorSpec`` shapes."""
    name: str

    def __repr__(self) -> str:
        return self.name


def symbolic_dims(spec: str) -> Tuple[SymDim, ...]:
    """``symbolic_dims("b, s")`` -> ``(SymDim('b'), SymDim('s'))``."""
    return tuple(SymDim(n.strip()) for n in spec.split(",") if n.strip())


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one step argument; dims are ints or ``SymDim``s."""
    shape: Tuple[Any, ...]
    dtype: torch.dtype

    def dim_exprs(self) -> Tuple[SymbolicExpr, ...]:
        return tuple(SymbolicExpr.var(d.name) if isinstance(d, SymDim)
                     else SymbolicExpr.constant(int(d)) for d in self.shape)


def spec_like(tree: Any) -> Any:
    """The ``TensorSpec`` pytree of a pytree of tensors (static shapes)."""
    return pytree.tree_map_only(
        torch.Tensor, lambda t: TensorSpec(tuple(t.shape), t.dtype), tree)


# ---------------------------------------------------------------------------
# Argument templates
# ---------------------------------------------------------------------------


class Arg:
    """Template leaf: the node's ``invals[i]``."""
    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __repr__(self) -> str:  # pragma: no cover
        return f"Arg({self.i})"


def has_symbolic(leaves: Sequence[Any]) -> bool:
    return any(isinstance(x, SymbolicExpr) for x in leaves)


def resolve_leaves(leaves: Sequence[Any], env: Mapping[str, int]) -> List[Any]:
    """Evaluate the ``SymbolicExpr`` leaves of a template for one env."""
    return [x.evaluate(env) if isinstance(x, SymbolicExpr) else x
            for x in leaves]


def override_template(node, overrides: Optional[Mapping[str, Any]]
                      ) -> Tuple[List[Any], Any]:
    """``node``'s argument template ``(leaves, spec)`` with the named
    arguments of its op replaced by ``overrides`` — a kernel variant's
    ``impl``, say.  The shared ``node.params`` stay as they are.

    The argument is found by name in the op's schema: a positional
    argument the call passed is replaced in place, one it left defaulted
    is passed by keyword."""
    leaves, spec = node.params["leaves"], node.params["spec"]
    if not overrides:
        return list(leaves), spec
    args, kwargs = pytree.tree_unflatten(list(leaves), spec)
    args, kwargs = list(args), dict(kwargs)
    schema = node.prim._schema.arguments
    for name, value in overrides.items():
        idx = next((i for i, a in enumerate(schema) if a.name == name), None)
        if idx is None:
            raise ValueError(f"{node.prim_name} has no argument {name!r}")
        if idx < len(args) and not schema[idx].kwarg_only:
            args[idx] = value
        else:
            kwargs[name] = value
    return pytree.tree_flatten((tuple(args), kwargs))


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59,
           61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127]


def _hints(names: Sequence[str], ranges: Mapping[str, Any]) -> Dict[str, int]:
    """A trace-time example size per dim: >= 2 (ShapeEnv specialises 0/1),
    inside the declared range where it allows, and distinct across dims."""
    out: Dict[str, int] = {}
    for name in names:
        lo, hi = parse_range_spec(ranges[name]) if name in ranges \
            else (None, None)
        lo = max(2, lo or 2)
        pick = next((p for p in _PRIMES if p >= lo
                     and (hi is None or p <= hi)
                     and p not in out.values()), None)
        if pick is None:
            pick = lo
            while pick in out.values():
                pick += 1
        out[name] = pick
    return out


def _refuse_pinned_exprs(shape_env, names: Mapping[Any, str]) -> None:
    """Raise on a guard that pins an expression of the dims to a number
    (``Eq(round(2.5 * s / 8), 5)``: an ``int()`` of a size the step
    computes, such as an MoE capacity): the plan would hold only where
    the expression keeps its trace-time value, not over the dims' range."""
    import sympy
    for gd in shape_env.guards:
        expr = gd.expr
        if not isinstance(expr, sympy.Eq):
            continue
        used = sorted(names[s] for s in expr.free_symbols if s in names)
        lhs, rhs = expr.args
        if used and (lhs.is_number or rhs.is_number):
            raise ValueError(
                f"tracing pinned {expr} (dims {used}): the step computes a "
                f"number from their sizes and branches on it, so no single "
                f"plan covers their range")


def _is_view_op(op) -> bool:
    return bool(getattr(op, "is_view", False)) or op in _STORAGE_ALIASES


def capture(fn: Callable, specs: Sequence[Any], *,
            device: torch.device,
            ranges: Optional[Mapping[str, Any]] = None
            ) -> Tuple[Graph, List[str]]:
    """Trace ``fn(*specs)`` once with symbolic dims; return the graph and
    the ShapeEnv's guards (as strings, for inspection).

    ``specs`` is the positional argument pytree with ``TensorSpec`` leaves;
    ``ranges`` the declared dim ranges (used only to pick trace hints)."""
    from torch._dynamo.source import ConstantSource
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.fx.experimental.symbolic_shapes import DimDynamic, ShapeEnv

    flat_specs, in_tree = pytree.tree_flatten(tuple(specs))
    for s in flat_specs:
        if not isinstance(s, TensorSpec):
            raise TypeError(f"optimize() arguments must be TensorSpec pytrees,"
                            f" got a {type(s).__name__} leaf")
    dim_names: List[str] = []
    for s in flat_specs:
        for d in s.shape:
            if isinstance(d, SymDim) and d.name not in dim_names:
                dim_names.append(d.name)

    shape_env = ShapeEnv(duck_shape=False)
    mode = FakeTensorMode(shape_env=shape_env)
    sym_of: Dict[str, Any] = {}
    names: Dict[Any, str] = {}
    for name, hint in _hints(dim_names, ranges or {}).items():
        sym = shape_env.create_symbol(hint, source=ConstantSource(name),
                                      dynamic_dim=DimDynamic.DYNAMIC)
        sym_of[name] = shape_env.create_symintnode(sym, hint=hint)
        names[sym] = name
    with mode:
        fakes = [torch.empty(tuple(sym_of[d.name] if isinstance(d, SymDim)
                                   else int(d) for d in s.shape),
                             dtype=s.dtype, device=device)
                 for s in flat_specs]

    out_tree_box: List[Any] = []

    def flat_fn(*flat):
        out = fn(*pytree.tree_unflatten(list(flat), in_tree))
        flat_out, out_tree = pytree.tree_flatten(out)
        out_tree_box.append(out_tree)
        return tuple(flat_out)

    gm = make_fx(flat_fn, tracing_mode="symbolic")(*fakes)

    for sym, name in names.items():
        rep = shape_env.replacements.get(sym)
        if rep is not None and rep.is_number:
            raise ValueError(
                f"tracing specialised dim {name!r} to {rep}: the step "
                f"branches on its size, so no single plan covers its range")
    _refuse_pinned_exprs(shape_env, names)

    _name_bound_symbols(gm, shape_env, names)
    g = _convert(gm, [(s.dim_exprs(), s.dtype) for s in flat_specs], names)
    g.in_tree = in_tree
    g.out_tree = out_tree_box[-1]
    return g, [str(gd.expr) for gd in shape_env.guards]


def _introduced_symbol(node) -> Any:
    """The unbacked size symbol an introducer's fake created."""
    bindings = node.meta.get("unbacked_bindings")
    if not bindings:
        raise NotImplementedError(
            f"{node.target} introduces a bounded dim, but its fake made no "
            f"unbacked size")
    return next(iter(bindings))


def _name_bound_symbols(gm, shape_env, names: Dict[Any, str]) -> None:
    """Map each introducer's unbacked size onto ``__b<k>`` (in ``names``),
    in introduction order; raise where the trace equated one with another
    dim (an op mixing a tight payload with a full-extent tensor)."""
    bound: Dict[Any, str] = {}
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        if introduces_dim(str(node.target)) is not None:
            bound[_introduced_symbol(node)] = f"__b{len(bound)}"
    names.update(bound)
    for sym, bname in bound.items():
        rep = shape_env.replacements.get(sym)
        if rep is None:
            continue
        other = dim_to_expr(rep, names)
        op = _mixing_op(gm, sym, rep)
        raise NotImplementedError(
            f"{op or 'an op'} mixes the bounded dim {bname} with the "
            f"full-extent dim {other}: the bounded tensor is tight at run "
            f"time, so the two cannot meet; padding back to the cap at such "
            f"a consumer is not supported")


def _mixing_op(gm, sym, rep) -> Optional[str]:
    """The first op reading one tensor sized by ``sym`` and another sized
    by ``rep`` (raw, unreplaced sizes)."""
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        bounded = full = False
        for x in pytree.tree_leaves((node.args, node.kwargs)):
            val = getattr(x, "meta", {}).get("val")
            if not isinstance(val, torch.Tensor):
                continue
            for d in val.shape:
                if not isinstance(d, torch.SymInt):
                    continue
                raw = d.node._expr
                if sym in raw.free_symbols:
                    bounded = True
                elif raw == rep:
                    full = True
        if bounded and full:
            return str(node.target)
    return None


def _convert(gm, in_dims: Sequence[Any], names: Mapping[Any, str], *,
             positions: Optional[Sequence[int]] = None,
             is_body: bool = False) -> Graph:
    """Convert one fx graph.  ``in_dims`` holds each placeholder's dims and
    dtype, or a ``SymbolicExpr`` for a size a scan passes its body;
    ``positions`` a tensor placeholder's index in ``Graph.inputs``
    (default: in order).  A loop body (``is_body``) returns an owning copy
    of every view."""
    g = Graph()
    env: Dict[Any, Any] = {}      # fx node -> Value | SymbolicExpr | [Value]
    # bound symbol -> the declared extent its dim has in the reference
    # (where the payload is padded to it)
    extent_of: Dict[Atom, SymbolicExpr] = {}

    def exprs_of(shape) -> Tuple[SymbolicExpr, ...]:
        return tuple(dim_to_expr(d, names) for d in shape)

    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    n_tensors = sum(1 for x in in_dims if not isinstance(x, SymbolicExpr))
    if positions is None:
        positions = range(n_tensors)
    slots: List[Optional[Value]] = [None] * n_tensors
    pos_iter = iter(positions)
    for node, spec in zip(placeholders, in_dims):
        if isinstance(spec, SymbolicExpr):
            env[node] = spec
            continue
        pos = next(pos_iter)
        v = g.new_value(spec[0], spec[1], kind="input", name=f"in{pos}")
        slots[pos] = v
        env[node] = v
    g.inputs.extend(slots)

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "get_attr":
            t = getattr(gm, node.target)
            if not isinstance(t, torch.Tensor):
                # a scan body: converted with the scan node that reads it
                env[node] = t
                continue
            v = g.new_value(exprs_of(t.shape), t.dtype, kind="const",
                            const_val=t, name=str(node.target))
            g.consts.append(v)
            env[node] = v
        elif node.op == "call_function":
            if node.target is torch.ops.higher_order.scan:
                if is_body:
                    raise NotImplementedError(
                        "a scan inside a scan body is not rolled")
                _convert_scan(g, node, env, names)
            else:
                _convert_call(g, node, env, exprs_of)
                _record_intro(g, node, env, extent_of)
        elif node.op == "output":
            for x in pytree.tree_leaves(node.args[0]):
                v = env.get(x)
                if not isinstance(v, Value):
                    raise NotImplementedError(
                        f"step output {x} is not a tensor")
                if v.base is not None and (is_body
                                           or v.base.kind == "intermediate"):
                    # a returned view would pin its whole base to the end
                    # of the run (or, from a loop body, alias a carry
                    # across iterations): return an owning copy instead
                    out = g.new_value(v.dims, v.dtype)
                    g.add_node(_CLONE, [v, v.base], [out],
                               {"leaves": [Arg(0)],
                                "spec": pytree.tree_flatten(((0,), {}))[1],
                                "multi": False},
                               n_args=1)
                    v = out
                g.outputs.append(v)
        else:
            raise NotImplementedError(f"fx node kind {node.op!r}")
    return g


def _record_intro(g: Graph, node, env: Dict[Any, Any],
                  extent_of: Dict[Atom, SymbolicExpr]) -> None:
    """Record a bounded-dim introducer's ``BoundIntro`` and cap; give a
    chained one its ``pad_to`` (the declared extent of its input there)."""
    spec = introduces_dim(str(node.target))
    if spec is None:
        return
    outs = env[node]
    n = outs[0].producer
    pv = n.outvals[spec.padded_out]
    bdim = pv.dims[spec.axis]
    (bname,) = bdim.free_vars()
    cap = n.invals[spec.cap_arg].dims[spec.cap_axis]
    bound = {Atom(b) for b in g.bound_dims}
    extent = cap.substitute({a: extent_of[a] for a in bound
                             if a.name in cap.free_vars()})
    if extent != cap:
        leaves, tspec = override_template(n, {"pad_to": extent})
        n.params["leaves"], n.params["spec"] = leaves, tspec
    extent_of[Atom(bname)] = extent
    g.bound_dims[bname] = cap
    g.bound_intros[n.id] = BoundIntro(
        name=bname, cap=cap, node_id=n.id, padded_out=spec.padded_out,
        count_out=spec.count_out, axis=spec.axis)


def _convert_scan(g: Graph, node, env: Dict[Any, Any],
                  names: Mapping[Any, str]) -> None:
    """A symbolic-length forward scan -> one rolled loop node."""
    import torch.fx

    args = node.args
    if len(args) != 4 or node.kwargs or \
            not isinstance(args[1], (list, tuple)) or \
            not isinstance(args[2], (list, tuple)) or \
            not isinstance(args[3], (list, tuple)) or \
            not isinstance(env.get(args[0]), torch.fx.GraphModule):
        raise NotImplementedError(
            f"scan node with args {args} kwargs {node.kwargs}: expected "
            f"(combine_graph, init, xs, additional_inputs)")
    sub = env[args[0]]
    carries, xs = ([env[x] for x in group] for group in args[1:3])
    # additional inputs: the body's tensor constants, and sizes the body
    # reads (ints, or symbolic sizes of the outer graph)
    extra = [env[x] if isinstance(x, torch.fx.Node) else
             SymbolicExpr.constant(int(x)) for x in args[3]]
    consts = [v for v in extra if isinstance(v, Value)]
    ins = consts + carries + xs
    if not all(isinstance(v, Value) for v in carries + xs) or not all(
            isinstance(v, (Value, SymbolicExpr)) for v in extra):
        raise NotImplementedError("scan over a non-tensor input")
    nc, nk, nx = len(consts), len(carries), len(xs)
    if nx == 0 or not xs[0].dims or not xs[0].dims[0].free_vars():
        raise NotImplementedError(
            "a scan whose xs length is static is not rolled")
    holders = [n for n in sub.graph.nodes if n.op == "placeholder"]
    if len(holders) != nk + nx + len(extra):
        raise NotImplementedError(
            f"scan body takes {len(holders)} inputs, expected "
            f"{nk + nx + len(extra)}")
    # torch's body order is (carries, xs slices, additional inputs); ours
    # (consts, carries, xs)
    positions = [nc + i for i in range(nk + nx)] + list(range(nc))
    in_dims = [(tuple(dim_to_expr(d, names) for d in h.meta["val"].shape),
                h.meta["val"].dtype) for h in holders[:nk + nx]]
    in_dims += [v if isinstance(v, SymbolicExpr) else
                (v.dims, v.dtype) for v in extra]
    if any(introduces_dim(str(n.target)) for n in sub.graph.nodes
           if n.op == "call_function"):
        raise NotImplementedError(
            "a bounded dim inside a scan body is not supported")
    bg = _convert(sub, in_dims, names, positions=positions, is_body=True)
    if not rollable_body(bg, nc, nk):
        raise NotImplementedError(
            "the scan body passes a carry through to another slot, so it "
            "cannot be rolled")
    tensor_holders = list(range(nk + nx)) + [
        nk + nx + i for i, v in enumerate(extra) if isinstance(v, Value)]
    torch_index = [0] * len(positions)
    for ti, pos in zip(tensor_holders, positions):
        torch_index[pos] = ti
    body = LoopBody(graph=bg, num_consts=nc, num_carry=nk, num_xs=nx,
                    length_expr=xs[0].dims[0],
                    torch_index=tuple(torch_index))
    invals = list(ins)
    for v in ins:
        if v.base is not None and v.base not in invals:
            invals.append(v.base)
    fakes = list(node.meta["val"])
    if len(fakes) != len(bg.outputs):
        raise NotImplementedError("scan outputs do not match its body")
    outs = [g.new_value(tuple(dim_to_expr(d, names) for d in f.shape),
                        f.dtype) for f in fakes]
    g.add_node(node.target, invals, outs, {LOOP_PARAM: body, "multi": True},
               prim_name="scan", n_args=len(ins))
    env[node] = outs


def _convert_call(g: Graph, node, env: Dict[Any, Any], exprs_of) -> None:
    import torch.fx

    val = node.meta.get("val")
    target = node.target
    # shape arithmetic (sym_size, operator.*): fold into a SymbolicExpr
    if isinstance(val, (torch.SymInt, int)) and not isinstance(val, bool):
        env[node] = dim_to_expr(val, None) if isinstance(val, int) else \
            exprs_of([val])[0]
        return
    if target is operator.getitem:
        src = env[node.args[0]]
        if not isinstance(src, list):
            raise NotImplementedError(f"getitem on {node.args[0]}")
        env[node] = src[node.args[1]]
        return
    if not isinstance(target, torch._ops.OpOverload):
        raise NotImplementedError(f"unsupported call {target}")
    if target._schema.is_mutable:
        raise NotImplementedError(
            f"in-place op {target}: capture expects a functional step")

    leaves, spec = pytree.tree_flatten((tuple(node.args), dict(node.kwargs)))
    invals: List[Value] = []
    out_leaves: List[Any] = []
    for x in leaves:
        if isinstance(x, torch.fx.Node):
            v = env[x]
            if isinstance(v, Value):
                out_leaves.append(Arg(len(invals)))
                invals.append(v)
            elif isinstance(v, SymbolicExpr):
                out_leaves.append(v)
            else:
                raise NotImplementedError(f"argument {x} of {target}")
        else:
            out_leaves.append(x)
    n_args = len(invals)
    # view bases stay live for as long as a view of them is read
    for v in list(invals[:n_args]):
        b = v.base
        if b is not None and b not in invals:
            invals.append(b)

    multi = isinstance(val, (tuple, list))
    fakes = list(val) if multi else [val]
    if not all(isinstance(f, torch.Tensor) for f in fakes):
        raise NotImplementedError(f"{target} returns a non-tensor")
    base = None
    if _is_view_op(target):
        src = invals[0]
        base = src.base if src.base is not None else src
    outs = [g.new_value(exprs_of(f.shape), f.dtype, base=base)
            for f in fakes]
    g.add_node(target, invals, outs,
               {"leaves": out_leaves, "spec": spec, "multi": multi},
               n_args=n_args)
    env[node] = outs if multi else outs[0]


# ---------------------------------------------------------------------------
# Call-time binding of dims
# ---------------------------------------------------------------------------


def solve_env(graph: Graph, concrete_args: Sequence[Any]) -> Dict[str, int]:
    """Bind symbolic dim variables from the concrete shapes of flat inputs."""
    env: Dict[str, int] = {}
    deferred: List[Tuple[SymbolicExpr, int]] = []
    if len(concrete_args) != len(graph.inputs):
        raise ValueError(f"expected {len(graph.inputs)} flat inputs, got "
                         f"{len(concrete_args)}")
    for val, arr in zip(graph.inputs, concrete_args):
        shape = tuple(arr.shape)
        if len(shape) != len(val.dims):
            raise ValueError(f"rank mismatch for {val}: {shape}")
        for dim_expr, concrete in zip(val.dims, shape):
            fv = dim_expr.free_vars()
            if not fv:
                expected = dim_expr.evaluate({})
                if expected != concrete:
                    raise ValueError(f"static dim mismatch for {val}: "
                                     f"expected {expected}, got {concrete}")
            elif len(fv) == 1 and dim_expr == SymbolicExpr.var(next(iter(fv))):
                name = next(iter(fv))
                if name in env and env[name] != concrete:
                    raise ValueError(f"inconsistent binding for {name}: "
                                     f"{env[name]} vs {concrete}")
                env[name] = int(concrete)
            else:
                deferred.append((dim_expr, int(concrete)))
    for expr, concrete in deferred:
        got = expr.evaluate(env)
        if got != concrete:
            raise ValueError(f"composite dim mismatch: {expr}={got} vs "
                             f"{concrete}")
    return env


def check_declared_ranges(shape_graph, env: Dict[str, int]) -> None:
    """Raise when a solved dim lies outside its declared range: compile-time
    decisions (schedule, guaranteed peak and arena bounds) assume it."""
    for name, iv in shape_graph.declared_ranges.items():
        v = env.get(name)
        if v is not None and not iv.contains(v):
            raise ValueError(
                f"dim {name!r}={v} outside its declared range {iv}; "
                f"re-optimize with wider dynamic_dims to run this shape")
