from .memory import MemoryManager, MemoryStats
from .vm import ProgramVM, RunReport

__all__ = ["MemoryManager", "MemoryStats", "ProgramVM", "RunReport"]
