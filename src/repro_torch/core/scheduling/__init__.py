from .memsim import MemTimeline, simulate_peak, simulate_peak_bound
from .scheduler import OpScheduler, ScheduleResult, schedule_graph
from .exchange import exchange_pass

__all__ = ["MemTimeline", "simulate_peak", "simulate_peak_bound",
           "OpScheduler", "ScheduleResult", "schedule_graph", "exchange_pass"]
