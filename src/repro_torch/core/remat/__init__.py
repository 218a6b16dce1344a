from .planner import ExecutionPlan, build_plan

__all__ = ["ExecutionPlan", "build_plan"]
