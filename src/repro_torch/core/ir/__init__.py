from .capture import (Arg, SymDim, TensorSpec, capture, check_declared_ranges,
                      solve_env, spec_like, symbolic_dims)
from .graph import Graph, Node, Value

__all__ = ["Arg", "Graph", "Node", "SymDim", "TensorSpec", "Value", "capture",
           "check_declared_ranges", "solve_env", "spec_like", "symbolic_dims"]
