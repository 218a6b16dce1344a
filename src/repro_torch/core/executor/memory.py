"""Device memory accounting through the planned arena.

PyTorch's caching allocator owns the real buffers; this module keeps the
exact byte accounting over the tensors the executor holds — the same
decision inputs the paper's runtime takes from the CUDA caching allocator,
but precise and identical on every device.  Host offload and the eviction
hook come with ``memory_limit`` in a later part of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass
class MemoryStats:
    device_used: int = 0
    device_peak: int = 0
    # arena-plan counters (zero when running with memory_plan="none")
    arena_bytes: int = 0          # arena size for this env, growth included
    slots: int = 0                # arena-allocated slots (external excluded)
    reuse_ratio: float = 0.0      # allocations served by a reused buffer
    fragmentation_bytes: int = 0  # arena size - peak bytes in use at once
    arena_growth_bytes: int = 0   # checked-reuse / dynamic growth beyond plan
    donated_reuses: int = 0       # allocations landing in donated input slots


class MemoryManager:
    """Tracks per-tensor device residency (no limit in this part)."""

    def __init__(self, arena=None):
        self.stats = MemoryStats()
        self._device: Dict[int, int] = {}  # value id -> bytes
        # optional ArenaAllocator mirroring device residency through the
        # planned slots (every device alloc/free below notifies it)
        self.arena = arena

    def arena_release(self, vid: int) -> None:
        """Arena-only free for buffers this manager never counted
        (e.g. donated inputs under ``count_inputs=False``)."""
        if self.arena is not None:
            self.arena.free(vid)

    def alloc(self, vid: int, nbytes: int) -> None:
        if vid in self._device:
            raise RuntimeError(f"double alloc of value {vid}")
        self._device[vid] = nbytes
        self.stats.device_used += nbytes
        self.stats.device_peak = max(self.stats.device_peak,
                                     self.stats.device_used)
        if self.arena is not None:
            self.arena.alloc(vid, nbytes)

    def free(self, vid: int) -> None:
        b = self._device.pop(vid, None)
        if b is not None:
            self.stats.device_used -= b
            self.arena_release(vid)
