from .capture import (Arg, SymDim, TensorSpec, capture, check_declared_ranges,
                      solve_env, spec_like, symbolic_dims)
from .graph import Graph, Node, Value
from .loop import (LOOP_PARAM, LoopBody, LoopPlanInfo, is_loop_node,
                   loop_body_of, rollable_body)

__all__ = ["Arg", "Graph", "LOOP_PARAM", "LoopBody", "LoopPlanInfo", "Node",
           "SymDim", "TensorSpec", "Value", "capture",
           "check_declared_ranges", "is_loop_node", "loop_body_of",
           "rollable_body", "solve_env", "spec_like", "symbolic_dims"]
