"""Conversion between PyTorch symbolic sizes and our SymbolicExpr.

A traced ``torch.SymInt`` carries a sympy expression over the symbols of a
``ShapeEnv`` (``s26``, ``s49``...).  ``dim_to_expr`` walks that expression
structurally — ``Add``, ``Mul``, ``Pow`` with a nonnegative integer exponent,
``FloorDiv``, ``Mod``/``PythonMod``, ``Max``, ``Min`` and integer constants —
and renames each ShapeEnv symbol to the user's dim name through ``names``.
Any other form becomes an opaque named atom (sound: it only reduces
comparability, never correctness), as the JAX frontend does for unknown
dim operations.

This module is the bridge between the capture frontend (``ir.capture``)
and the paper's symbolic machinery.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

from .expr import SymbolicExpr


def _sympy():
    import sympy
    return sympy


def dim_to_expr(d: Any, names: Optional[Mapping[Any, str]] = None
                ) -> SymbolicExpr:
    """Convert an int, ``torch.SymInt`` or sympy expression to a SymbolicExpr.

    ``names`` maps sympy symbols to dim names; unmapped symbols keep their
    own name."""
    import torch
    if isinstance(d, bool):
        raise TypeError("a bool is not a dimension")
    if isinstance(d, int):
        return SymbolicExpr.constant(d)
    if isinstance(d, torch.SymInt):
        d = d.node.expr
    sympy = _sympy()
    if not isinstance(d, sympy.Basic):
        raise TypeError(f"not a dimension: {type(d)}")
    return _convert(d, names or {})


def _convert(e, names: Mapping[Any, str]) -> SymbolicExpr:
    sympy = _sympy()
    from torch.utils._sympy.functions import FloorDiv, Mod, PythonMod

    if getattr(e, "is_Integer", False):
        return SymbolicExpr.constant(int(e))
    if getattr(e, "is_Symbol", False):
        return SymbolicExpr.var(names.get(e, str(e)))

    def args():
        return [_convert(a, names) for a in e.args]

    if isinstance(e, sympy.Add):
        out = SymbolicExpr.constant(0)
        for a in args():
            out = out + a
        return out
    if isinstance(e, sympy.Mul):
        out = SymbolicExpr.constant(1)
        for a in args():
            out = out * a
        return out
    if isinstance(e, sympy.Pow) and e.args[1].is_Integer \
            and int(e.args[1]) >= 0:
        b = _convert(e.args[0], names)
        out = SymbolicExpr.constant(1)
        for _ in range(int(e.args[1])):
            out = out * b
        return out
    if isinstance(e, FloorDiv):
        n, d = args()
        return n.floordiv(d)
    if isinstance(e, (Mod, PythonMod, sympy.Mod)):
        n, d = args()
        return n.mod(d)
    if isinstance(e, (sympy.Max, sympy.Min)):
        fold = SymbolicExpr.max_of if isinstance(e, sympy.Max) \
            else SymbolicExpr.min_of
        out, *rest = args()
        for a in rest:
            out = fold(out, a)
        return out
    # unknown form: a fresh named atom keyed by its printed form
    return SymbolicExpr.var(f"opaque<{e}>")


# -- declared dim ranges (bounded dynamic shapes) -----------------------------


def parse_range_spec(spec: Any) -> Tuple[Any, Any]:
    """Parse a user-facing dim-range spec into ``(lo, hi)``.

    Accepted forms (``None`` = unbounded on that side):

    - ``(lo, hi)`` tuple/list — either entry may be ``None``;
    - a bare ``int`` N — torch_xla-style ``<=N`` upper bound, lo defaults 1;
    - strings ``"lo..hi"``, ``"..hi"``, ``"lo.."``, ``"<=hi"``, ``">=lo"``.
    """
    if isinstance(spec, int):
        return 1, int(spec)
    if isinstance(spec, (tuple, list)):
        if len(spec) != 2:
            raise ValueError(f"range spec must be (lo, hi), got {spec!r}")
        lo, hi = spec
        return (None if lo is None else int(lo),
                None if hi is None else int(hi))
    if isinstance(spec, str):
        s = spec.replace(" ", "")
        if s.startswith("<="):
            return 1, int(s[2:])
        if s.startswith(">="):
            return int(s[2:]), None
        if ".." in s:
            lo_s, hi_s = s.split("..", 1)
            return (int(lo_s) if lo_s else None), (int(hi_s) if hi_s else None)
        raise ValueError(f"unrecognized range spec {spec!r}")
    raise TypeError(f"unrecognized range spec {spec!r}")


def declare_dim_ranges(shape_graph: Any, specs: Optional[Mapping[str, Any]]) -> None:
    """Record ``optimize(..., dynamic_dims=...)`` range specs on a ShapeGraph.

    ``specs`` maps symbolic dim names (as written in ``symbolic_dims``) to
    :func:`parse_range_spec`-accepted values.  Dims traced but absent from
    ``specs`` keep the default ``[1, +inf)`` assumption.
    """
    if not specs:
        return
    for name, spec in specs.items():
        lo, hi = parse_range_spec(spec)
        shape_graph.declare_range(name, lo, hi)
