from .interpreter import PlanInterpreter
from .memory import MemoryLimitExceeded, MemoryManager, MemoryStats
from .vm import ProgramVM, RunReport

__all__ = ["MemoryLimitExceeded", "MemoryManager", "MemoryStats",
           "PlanInterpreter", "ProgramVM", "RunReport"]
