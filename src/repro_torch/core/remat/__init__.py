from .planner import ExecutionPlan, build_plan
from .runtime import RuntimeRematPolicy
from .search import CandidateInfo, RecomputePlan, RecomputeSearcher

__all__ = ["CandidateInfo", "ExecutionPlan", "RecomputePlan",
           "RecomputeSearcher", "RuntimeRematPolicy", "build_plan"]
