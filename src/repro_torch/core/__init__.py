"""BladeDISC++-style memory optimization for dynamic-shape PyTorch steps.

The paper's primary contribution lives here: symbolic shape analysis
(``repro_torch.core.symbolic``), the graph IR and its capture frontend
(``repro_torch.core.ir``), op scheduling (``repro_torch.core.scheduling``),
rematerialization (``repro_torch.core.remat``), the symbolic memory planner
(``repro_torch.core.memplan``), the executors — the register VM and the
op-by-op interpreter (``repro_torch.core.executor``) — bucketed
specialization (``repro_torch.core.dispatch``) and observability
(``repro_torch.core.obs``: compile spans, the decision log, per-call
telemetry, memory timelines), wired together by :func:`optimize`.
"""
from .api import (DynamicShapeFunction, MemoryLimitExceeded, OptimizeReport,
                  TensorSpec, optimize, resolve_device, scan, spec_like,
                  symbolic_dim, symbolic_dims)
from .dispatch import (BucketPlan, BucketSpace, SpecializationTable,
                       build_bucket_space)
from .executor import PlanInterpreter, ProgramVM
from .lowering import Program, lower_plan

__all__ = ["BucketPlan", "BucketSpace", "DynamicShapeFunction",
           "MemoryLimitExceeded", "OptimizeReport", "PlanInterpreter",
           "Program", "ProgramVM", "SpecializationTable", "TensorSpec",
           "build_bucket_space", "lower_plan", "optimize", "resolve_device",
           "scan", "spec_like", "symbolic_dim", "symbolic_dims"]
