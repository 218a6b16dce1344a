"""Symbolic memory planner: compile-time buffer reuse for dynamic shapes.

The pipeline's final stage.  Given the scheduled order, ``liveness``
computes symbolic live intervals per value, ``assign`` greedily packs
values into reusable *slots* — proving fit with the shape graph's symbolic
comparison (interval fallback included) — and emits an :class:`ArenaPlan`
with per-slot symbolic size expressions and, when every dynamic dim is
bounded, a guaranteed worst-case arena size.  ``arena`` is the runtime
half: an :class:`ArenaAllocator` that evaluates the slot sizes once per
dim binding and accounts the executor's alloc/free traffic through the
planned slots.
"""
from .liveness import LiveInterval, analyze_liveness
from .assign import ArenaPlan, SlotAssignment, SlotInfo, build_arena_plan
from .arena import ArenaAllocator

__all__ = [
    "LiveInterval", "analyze_liveness",
    "ArenaPlan", "SlotAssignment", "SlotInfo", "build_arena_plan",
    "ArenaAllocator",
]
