from .expr import Atom, OpAtom, SymbolicExpr, ZERO, ONE, size_of
from .intervals import BoundEnv, Interval, as_interval
from .shape_graph import Cmp, ShapeGraph
from .from_torch import declare_dim_ranges, dim_to_expr, parse_range_spec

__all__ = [
    "Atom", "OpAtom", "SymbolicExpr", "ZERO", "ONE", "size_of",
    "BoundEnv", "Interval", "as_interval",
    "Cmp", "ShapeGraph",
    "declare_dim_ranges", "dim_to_expr", "parse_range_spec",
]
