"""Plan -> Program lowering.

Compiles each (schedule, arena plan) pair into a flat :class:`Program` of
typed instructions over dense registers — the executable artifact the
register :class:`~repro_torch.core.executor.vm.ProgramVM` runs.
``Program.resolve(env)`` realizes every attached symbolic expression
(sizes, op arguments, slot offsets) for one dim binding in a single pass.
"""
from .lower import lower_plan
from .program import (BindArg, Compute, Donate, FreeSlot, Program,
                      ResolvedProgram, Return)

__all__ = ["lower_plan", "Program", "ResolvedProgram",
           "BindArg", "Compute", "FreeSlot", "Donate", "Return"]
