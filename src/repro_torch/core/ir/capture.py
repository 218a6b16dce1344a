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
  ``u<k>`` by that dim; capture keeps the unreplaced ``__b<k>`` and pads
  the tight operand with zeros to its declared extent before every op
  that meets a full-extent operand, which is what the reference's op
  sees: that op's output stays at the cap, as the reference's
  ``_propagate`` leaves it.  An introducer whose input carries a bound
  dim gets that dim's declared extent as its ``pad_to`` argument: it
  pads the tight input with zeros to that length, for the same reason.
* **scans** (``ir.loop``): a ``torch.ops.higher_order.scan`` whose ``xs``
  have a symbolic length becomes one rolled loop node, its body converted
  once (with the outer dim names) into a sub-``Graph``.  A scan the roll
  gate refuses becomes one opaque node (``OpaqueScan``) that runs the
  captured body, as the reference keeps it; so does a scan inside a
  rolled body, whose body the reference traces with ``roll_loops=False``.
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
from .loop import LOOP_PARAM, LoopBody, OpaqueScan, rollable_body

_CLONE = torch.ops.aten.clone.default
# ops that return their input's storage without the schema marking an
# alias: a functional collective's ``wait_tensor`` returns the buffer its
# collective wrote, so it is counted once
_STORAGE_ALIASES = (torch.ops.aten._unsafe_view.default,
                    torch.ops._c10d_functional.wait_tensor.default)
_IDENTITY_VIEWS = (torch.ops.aten.view.default,
                   torch.ops.aten._unsafe_view.default,
                   torch.ops.aten.alias.default)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SymDim:
    """A named symbolic dimension usable inside ``TensorSpec`` shapes."""
    name: str

    def __repr__(self) -> str:
        return self.name


def symbolic_dim(name: str) -> SymDim:
    """One symbolic dimension: ``symbolic_dim("s")`` -> ``SymDim('s')``."""
    return SymDim(name.strip())


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


@dataclass(frozen=True)
class TreeDef:
    """The structure of an argument or output pytree, with ``None`` as an
    empty subtree, as in the reference's (JAX) pytrees: torch's pytree
    keeps ``None`` as a leaf, so ``holes`` records where its Nones were."""
    spec: Any
    holes: Tuple[int, ...]


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    """``tree``'s leaves without its Nones, and its ``TreeDef``."""
    leaves, spec = pytree.tree_flatten(tree)
    holes = tuple(i for i, x in enumerate(leaves) if x is None)
    return [x for x in leaves if x is not None], TreeDef(spec, holes)


def tree_unflatten(leaves: Sequence[Any], tree: TreeDef) -> Any:
    """The inverse of ``tree_flatten``: the Nones go back where they were."""
    it = iter(leaves)
    holes = set(tree.holes)
    return pytree.tree_unflatten(
        [None if i in holes else next(it)
         for i in range(tree.spec.num_leaves)], tree.spec)


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

    ``specs`` is the positional argument pytree with ``TensorSpec`` leaves
    (a ``None`` in it is an empty subtree, passed to ``fn`` as ``None``);
    ``ranges`` the declared dim ranges (used only to pick trace hints)."""
    from torch._dynamo.source import ConstantSource
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.fx.experimental.symbolic_shapes import DimDynamic, ShapeEnv

    flat_specs, in_tree = tree_flatten(tuple(specs))
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
        out = fn(*tree_unflatten(flat, in_tree))
        flat_out, out_tree = tree_flatten(out)
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

    mixed = _name_bound_symbols(gm, shape_env, names)
    g = _convert(gm, [(s.dim_exprs(), s.dtype) for s in flat_specs], names,
                 mixed=mixed)
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


def _name_bound_symbols(gm, shape_env, names: Dict[Any, str]
                        ) -> Optional["_Mixed"]:
    """Map each introducer's unbacked size onto ``__b<k>`` (in ``names``),
    in introduction order.  Return the bound symbols the trace equated
    with another dim (an op mixing a tight payload with a full-extent
    tensor), or ``None``."""
    bound: Dict[Any, str] = {}
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        if introduces_dim(str(node.target)) is not None:
            bound[_introduced_symbol(node)] = f"__b{len(bound)}"
    names.update(bound)
    reps = shape_env.replacements
    equated = {sym: reps[sym] for sym in bound if reps.get(sym) is not None}
    if not equated:
        return None
    return _Mixed(
        syms=frozenset(equated),
        others={k: v for k, v in reps.items() if k not in equated},
        extent={bound[sym]: dim_to_expr(rep, names)
                for sym, rep in equated.items()})


@dataclass(frozen=True)
class _Mixed:
    """Bound symbols the trace equated with a full-extent dim: ``syms``
    (sympy), the ShapeEnv's other replacements, and per bound name the
    dim it was equated with."""
    syms: frozenset
    others: Dict[Any, Any]
    extent: Dict[str, SymbolicExpr]

    def unreplaced(self, d: Any) -> Any:
        """``d``'s expression with these symbols left unreplaced."""
        if isinstance(d, torch.SymInt):
            raw = d.node._expr
            if raw.free_symbols & self.syms:
                return raw.xreplace(self.others)
        return d


def _convert(gm, in_dims: Sequence[Any], names: Mapping[Any, str], *,
             positions: Optional[Sequence[int]] = None,
             is_body: bool = False, mixed: Optional[_Mixed] = None
             ) -> Graph:
    """Convert one fx graph.  ``in_dims`` holds each placeholder's dims and
    dtype, or a ``SymbolicExpr`` for a size a scan passes its body;
    ``positions`` a tensor placeholder's index in ``Graph.inputs``
    (default: in order).  A loop body (``is_body``) returns an owning copy
    of every view, and a scan inside it stays opaque.  ``mixed``: the
    bound dims an op equated with a full-extent dim."""
    g = Graph()
    env: Dict[Any, Any] = {}      # fx node -> Value | SymbolicExpr | [Value]
    # bound symbol -> the declared extent its dim has in the reference
    # (where the payload is padded to it)
    extent_of: Dict[Atom, SymbolicExpr] = {}
    # bound name -> extent, for the bound dims an op mixes with a full
    # extent (their operands are padded to it there)
    pad_to: Dict[str, SymbolicExpr] = {}

    def exprs_of(shape) -> Tuple[SymbolicExpr, ...]:
        if mixed is not None:
            shape = [mixed.unreplaced(d) for d in shape]
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
                _convert_scan(g, node, env, names, roll=not is_body)
            else:
                _convert_call(g, node, env, exprs_of, pad_to)
                _record_intro(g, node, env, extent_of, pad_to, mixed)
        elif node.op == "output":
            for x in pytree.tree_leaves(node.args[0]):
                v = env.get(x)
                if not isinstance(v, Value):
                    raise NotImplementedError(
                        f"step output {x} is not a tensor")
                if v.base is not None and not is_body and \
                        _whole_of_base(v):
                    # the view is all of its base, as it lies (DTensor's
                    # ``to_local`` returns a shard so): return the base
                    v = v.base
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


def _whole_of_base(v: Value) -> bool:
    """``v`` is a same-shape ``view``/``alias`` of its base itself: the
    same bytes in the same layout."""
    p = v.producer
    return p is not None and p.prim in _IDENTITY_VIEWS and \
        p.invals[0] is v.base and v.dims == v.base.dims and \
        v.dtype == v.base.dtype and v.base.kind == "intermediate"


def _record_intro(g: Graph, node, env: Dict[Any, Any],
                  extent_of: Dict[Atom, SymbolicExpr],
                  pad_to: Dict[str, SymbolicExpr],
                  mixed: Optional[_Mixed]) -> None:
    """Record a bounded-dim introducer's ``BoundIntro`` and cap; give a
    chained one its ``pad_to`` (the declared extent of its input there).
    A bound dim the trace equated with a full-extent dim goes into
    ``pad_to``, if that dim is its declared extent."""
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
    if mixed is not None and bname in mixed.extent:
        if mixed.extent[bname] != extent:
            raise NotImplementedError(
                f"an op equates the bounded dim {bname} with "
                f"{mixed.extent[bname]}, which is not its declared extent "
                f"{extent}: the reference's padded payload could not meet it")
        pad_to[bname] = extent
    g.bound_dims[bname] = cap
    g.bound_intros[n.id] = BoundIntro(
        name=bname, cap=cap, node_id=n.id, padded_out=spec.padded_out,
        count_out=spec.count_out, axis=spec.axis)


def _convert_scan(g: Graph, node, env: Dict[Any, Any],
                  names: Mapping[Any, str], *, roll: bool) -> None:
    """A scan -> one rolled loop node where the roll gate admits it (a
    symbolic length, no bounded dim in the body, every carry produced or
    kept in its own slot; ``roll``: not inside a rolled body), else one
    opaque node (``OpaqueScan``), as the reference's trace keeps it."""
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
    holders = [n for n in sub.graph.nodes if n.op == "placeholder"]
    if len(holders) != nk + nx + len(extra):
        raise NotImplementedError(
            f"scan body takes {len(holders)} inputs, expected "
            f"{nk + nx + len(extra)}")
    invals = list(ins)
    for v in ins:
        if v.base is not None and v.base not in invals:
            invals.append(v.base)
    fakes = list(node.meta["val"])
    if len(fakes) < nk:
        raise NotImplementedError("scan outputs do not match its body")
    outs = [g.new_value(tuple(dim_to_expr(d, names) for d in f.shape),
                        f.dtype) for f in fakes]
    known = set(names.values())
    for v in outs:
        for d in v.dims:
            if not d.free_vars() <= known:
                raise NotImplementedError(
                    f"a scan output's size {d} depends on values computed "
                    f"inside its body")
    body = _rolled_body(sub, holders, names, extra, nc, nk, nx, xs) \
        if roll else None
    if body is not None:
        if len(fakes) != len(body.graph.outputs):
            raise NotImplementedError("scan outputs do not match its body")
        g.add_node(node.target, invals, outs,
                   {LOOP_PARAM: body, "multi": True},
                   prim_name="scan", n_args=len(ins))
    else:
        # opaque: the node reads every input and writes the scan's outputs
        # at the fakes' shapes; its op runs the captured body
        const_arg = iter(range(nc))
        add_leaves = [Arg(next(const_arg)) if isinstance(v, Value) else
                      (v.evaluate({}) if not v.free_vars() else v)
                      for v in extra]
        leaves, spec = pytree.tree_flatten((
            ([Arg(nc + i) for i in range(nk)],
             [Arg(nc + nk + i) for i in range(nx)], add_leaves), {}))
        g.add_node(OpaqueScan(sub, nk), invals, outs,
                   {"leaves": leaves, "spec": spec, "multi": True},
                   prim_name="scan", n_args=len(ins))
    env[node] = outs


def _rolled_body(sub, holders, names: Mapping[Any, str], extra, nc: int,
                 nk: int, nx: int, xs: Sequence[Value]
                 ) -> Optional[LoopBody]:
    """The scan's ``LoopBody`` when the roll gate admits it, else None."""
    if nx == 0 or not xs[0].dims or not xs[0].dims[0].free_vars():
        return None                   # a static length gains nothing
    if any(introduces_dim(str(n.target)) for n in sub.graph.nodes
           if n.op == "call_function"):
        # a bounded dim would need a BindDim per iteration; the rolled
        # accounting has no per-step env, so the scan stays opaque
        return None
    # torch's body order is (carries, xs slices, additional inputs); ours
    # (consts, carries, xs)
    positions = [nc + i for i in range(nk + nx)] + list(range(nc))
    in_dims = [(tuple(dim_to_expr(d, names) for d in h.meta["val"].shape),
                h.meta["val"].dtype) for h in holders[:nk + nx]]
    in_dims += [v if isinstance(v, SymbolicExpr) else
                (v.dims, v.dtype) for v in extra]
    bg = _convert(sub, in_dims, names, positions=positions, is_body=True)
    if not rollable_body(bg, nc, nk):
        return None                   # a carry passed to another slot
    tensor_holders = list(range(nk + nx)) + [
        nk + nx + i for i, v in enumerate(extra) if isinstance(v, Value)]
    torch_index = [0] * len(positions)
    for ti, pos in zip(tensor_holders, positions):
        torch_index[pos] = ti
    return LoopBody(graph=bg, num_consts=nc, num_carry=nk, num_xs=nx,
                    length_expr=xs[0].dims[0],
                    torch_index=tuple(torch_index))


def _convert_call(g: Graph, node, env: Dict[Any, Any], exprs_of,
                  pad_to: Mapping[str, SymbolicExpr]) -> None:
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
        target = _out_of_place(node, env)

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
    subst = _pad_mixed(g, invals, pad_to) if pad_to else {}
    if subst:
        out_leaves = [x.substitute(subst) if isinstance(x, SymbolicExpr)
                      else x for x in out_leaves]
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
    outs = [g.new_value(tuple(d.substitute(subst) if subst else d
                              for d in exprs_of(f.shape)), f.dtype,
                        base=base)
            for f in fakes]
    g.add_node(target, invals, outs,
               {"leaves": out_leaves, "spec": spec, "multi": multi},
               n_args=n_args)
    env[node] = outs if multi else outs[0]


def _out_of_place(node, env: Dict[Any, Any]) -> Any:
    """The out-of-place twin of an in-place op that writes an intermediate
    nothing reads afterwards and no view shares (DTensor zeroes the
    out-of-range rows of a sharded lookup so, before reducing it): the
    graph then stays functional.  Any other in-place op is refused."""
    import torch.fx

    target = node.target
    schema = target._schema
    name = schema.name.split("::")[-1]
    writes = [a.alias_info is not None and a.alias_info.is_write
              for a in schema.arguments]
    src = node.args[0] if node.args else None
    twin = getattr(getattr(torch.ops.aten, name[:-1], None),
                   target._overloadname, None) if name.endswith("_") \
        else None
    if twin is not None and writes[0] and not any(writes[1:]) and \
            isinstance(src, torch.fx.Node):
        v = env.get(src)
        order = {n: i for i, n in enumerate(node.graph.nodes)}
        readers = [u for u in src.users if u is not node]
        if isinstance(v, Value) and v.kind == "intermediate" and \
                v.base is None and all(
                    order[u] < order[node] and not (
                        isinstance(u.target, torch._ops.OpOverload)
                        and _is_view_op(u.target)) for u in readers):
            return twin
    raise NotImplementedError(
        f"in-place op {target}: capture expects a functional step")


def _pad_mixed(g: Graph, invals: List[Value],
               pad_to: Mapping[str, SymbolicExpr]) -> Dict[Atom, SymbolicExpr]:
    """An op that meets a tight operand carrying a bound dim the trace
    equated with a full extent, and an operand with that full extent:
    pad the tight operand (``invals``, in place) with zeros to the dim's
    declared extent, which is what the reference's op reads.  Return, for
    every such dim that no operand carries tight any more, its extent:
    the op's output and its size arguments are at the cap there (the
    trace wrote them in the bound symbol)."""
    subst: Dict[Atom, SymbolicExpr] = {}
    for bname, extent in pad_to.items():
        tight = [i for i, v in enumerate(invals)
                 if any(bname in d.free_vars() for d in v.dims)]
        if tight and any(d == extent for i, v in enumerate(invals)
                         if i not in tight for d in v.dims):
            padded: Dict[int, Value] = {}
            for i in tight:
                v = invals[i]
                if v.id not in padded:
                    padded[v.id] = _pad_to_extent(g, v, bname, extent)
                invals[i] = padded[v.id]
            tight = []
        if not tight:
            subst[Atom(bname)] = extent
    return subst


def _pad_to_extent(g: Graph, v: Value, bname: str,
                   extent: SymbolicExpr) -> Value:
    """A ``constant_pad_nd`` node padding ``v``'s bound dim ``bname`` with
    zeros to ``extent``."""
    var = SymbolicExpr.var(bname)
    axes = [a for a, d in enumerate(v.dims) if bname in d.free_vars()]
    if any(v.dims[a] != var for a in axes):
        raise NotImplementedError(
            f"an op mixes the bounded dim {bname}, inside {v.dims}, with the "
            f"full-extent dim {extent}: padding to the cap needs the bounded "
            f"dim as a dim of its own")
    pad: List[Any] = []
    for a in reversed(range(len(v.dims))):
        pad += [0, extent - var] if a in axes else [0, 0]
    leaves, spec = pytree.tree_flatten(((Arg(0), pad), {}))
    out = g.new_value(tuple(extent if a in axes else d
                            for a, d in enumerate(v.dims)), v.dtype)
    ins = [v] if v.base is None else [v, v.base]
    g.add_node(torch.ops.aten.constant_pad_nd.default, ins, [out],
               {"leaves": leaves, "spec": spec, "multi": False}, n_args=1)
    return out


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
