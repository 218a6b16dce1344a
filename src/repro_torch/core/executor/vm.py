"""Slim register VM over a lowered :class:`~repro_torch.core.lowering.Program`.

The fast stream of the reference VM: per call, one cached
``Program.resolve`` for the dim binding, then a hot loop that gathers
input registers, calls the op, stores outputs and nulls dead registers.
Dropping a dead register's reference is the free: PyTorch's caching
allocator takes the storage back once nothing aliases it.  The call's
complete ``MemoryStats`` was precomputed by the resolve replay.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from torch.utils import _pytree as pytree

from ..ir.capture import check_declared_ranges, solve_env
from ..lowering.program import (OP_BIND_ARG, OP_COMPUTE, OP_DONATE,
                                OP_FREE_SLOT, Program, ResolvedProgram)
from .memory import MemoryStats


@dataclass
class RunReport:
    stats: MemoryStats
    wall_s: float
    env: Dict[str, int] = field(default_factory=dict)


class ProgramVM:
    """Executes a lowered Program."""

    def __init__(self, program: Program):
        self.program = program
        self.plan = program.plan

    def run(self, flat_args: Sequence[Any],
            env: Optional[Dict[str, int]] = None
            ) -> Tuple[List[Any], RunReport]:
        t0 = time.perf_counter()
        prog = self.program
        if env is None:
            env = solve_env(prog.graph, flat_args)
            check_declared_ranges(prog.plan.shape_graph, env)
        resolved = prog.resolve(env)
        outs = self._run_fast(flat_args, resolved)
        wall = time.perf_counter() - t0
        return outs, RunReport(stats=prog.stats_for(resolved), wall_s=wall,
                               env=env)

    def _run_fast(self, flat_args: Sequence[Any],
                  resolved: ResolvedProgram) -> List[Any]:
        prog = self.program
        storage: List[Any] = [None] * prog.n_regs
        all_leaves = resolved.leaves
        unflatten = pytree.tree_unflatten
        for inst in prog.instructions:
            op = inst.op
            if op == OP_COMPUTE:
                leaves = list(all_leaves[inst.cidx])
                in_regs = inst.in_regs
                for li, k in inst.arg_slots:
                    leaves[li] = storage[in_regs[k]]
                args, kwargs = unflatten(leaves, inst.spec)
                out = inst.prim(*args, **kwargs)
                del leaves, args, kwargs
                if inst.multi:
                    for oi, r in inst.store:
                        storage[r] = out[oi]
                else:
                    for _oi, r in inst.store:
                        storage[r] = out
                del out
            elif op == OP_BIND_ARG:
                storage[inst.reg] = (flat_args[inst.index]
                                     if inst.index >= 0 else inst.const)
            elif op == OP_FREE_SLOT or op == OP_DONATE:
                storage[inst.reg] = None
        return [storage[r] for r in prog.out_regs]
