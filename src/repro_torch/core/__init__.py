"""BladeDISC++-style memory optimization for dynamic-shape PyTorch steps.

The paper's primary contribution lives here: symbolic shape analysis
(``repro_torch.core.symbolic``), the graph IR and its capture frontend
(``repro_torch.core.ir``), op scheduling (``repro_torch.core.scheduling``),
the symbolic memory planner (``repro_torch.core.memplan``) and the register
VM (``repro_torch.core.executor``), wired together by :func:`optimize`.
"""
from .api import (DynamicShapeFunction, OptimizeReport, TensorSpec, optimize,
                  resolve_device, spec_like, symbolic_dims)
from .executor import ProgramVM
from .lowering import Program, lower_plan

__all__ = ["DynamicShapeFunction", "OptimizeReport", "Program", "ProgramVM",
           "TensorSpec", "lower_plan", "optimize", "resolve_device",
           "spec_like", "symbolic_dims"]
