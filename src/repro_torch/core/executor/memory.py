"""Device/host memory accounting with a limit and an eviction hook.

Port of ``repro/core/executor/memory.py``.  PyTorch's caching allocator
owns the real buffers; this module keeps the exact byte accounting over
the tensors the executor holds — the same decision inputs the paper's
runtime takes from the CUDA caching allocator, but precise and identical
on every device.  The host pool is the pinned host memory that offloaded
tensors wait in (plain host memory on the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


class MemoryLimitExceeded(RuntimeError):
    pass


@dataclass
class MemoryStats:
    device_used: int = 0
    device_peak: int = 0
    host_used: int = 0
    host_peak: int = 0
    evictions: int = 0
    evicted_bytes: int = 0
    reloads: int = 0
    recomputes: int = 0
    recompute_flops: int = 0
    offloads: int = 0
    # victims the policy chose to recompute, offloaded instead because a
    # source of their recompute was no longer materializable
    recompute_fallbacks: int = 0
    # arena-plan counters (zero when running with memory_plan="none")
    arena_bytes: int = 0          # arena size for this env, growth included
    slots: int = 0                # arena-allocated slots (external excluded)
    reuse_ratio: float = 0.0      # allocations served by a reused buffer
    fragmentation_bytes: int = 0  # arena size - peak bytes in use at once
    arena_growth_bytes: int = 0   # checked-reuse / dynamic growth beyond plan
    donated_reuses: int = 0       # allocations landing in donated input slots
    # bucketed-dispatch counters (zero without optimize(..., buckets=...));
    # every counter here is cumulative over the function's lifetime as of
    # this call, while last_* fields describe this call alone —
    # last_dispatch_ns is this call's bucket-resolution time (a miss
    # includes the bucket's specialization compile), dispatch_ns_total the
    # lifetime sum of those
    bucket_hits: int = 0
    specialize_count: int = 0
    last_dispatch_ns: int = 0
    dispatch_ns_total: int = 0
    # value-dependent bounded dims: the extents measured by this call's
    # BindDim steps (bound symbol -> measured value, not the cap).  Empty
    # for purely range-dynamic graphs.
    measured_dims: Dict[str, int] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


class MemoryManager:
    """Tracks per-tensor residency; enforces a device-bytes limit.

    ``ensure(nbytes)`` is the paper's ``Remat::EvictOp`` trigger: called
    before each allocation, it invokes the eviction callback until the
    allocation fits (or raises).
    """

    def __init__(self, limit_bytes: Optional[int] = None, arena=None):
        self.limit = limit_bytes
        self.stats = MemoryStats()
        self._device: Dict[int, int] = {}  # value id -> bytes
        self._host: Dict[int, int] = {}
        self.evict_callback: Optional[Callable[[int], int]] = None
        # optional ArenaAllocator mirroring device residency through the
        # planned slots (every device alloc/free below notifies it)
        self.arena = arena
        # fault injection (resilience): called as hook(event, vid, nbytes)
        # before alloc / evict_to_host / reload / restore mutate state, so
        # an injected failure aborts the call with accounting consistent.
        # None (the default) costs one attribute test per event.
        self.fault_hook: Optional[Callable[[str, int, int], None]] = None

    def _arena_alloc(self, vid: int, nbytes: int) -> None:
        if self.arena is not None:
            self.arena.alloc(vid, nbytes)

    def arena_release(self, vid: int) -> None:
        """Arena-only free for buffers this manager never counted
        (e.g. donated inputs under ``count_inputs=False``)."""
        if self.arena is not None:
            self.arena.free(vid)

    def _grow(self, nbytes: int) -> None:
        self.stats.device_used += nbytes
        self.stats.device_peak = max(self.stats.device_peak,
                                     self.stats.device_used)

    def device_bytes(self, vid: int) -> int:
        return self._device.get(vid, 0)

    # -- allocation lifecycle ----------------------------------------------------
    def ensure(self, nbytes: int) -> None:
        if self.limit is None:
            return
        if self.stats.device_used + nbytes <= self.limit:
            return
        if self.evict_callback is not None:
            need = self.stats.device_used + nbytes - self.limit
            self.evict_callback(need)
        if self.stats.device_used + nbytes > self.limit:
            raise MemoryLimitExceeded(
                f"need {nbytes} bytes; used {self.stats.device_used} of "
                f"limit {self.limit} and eviction could not free enough")

    def alloc(self, vid: int, nbytes: int) -> None:
        if self.fault_hook is not None:
            self.fault_hook("alloc", vid, nbytes)
        if vid in self._device:
            raise RuntimeError(f"double alloc of value {vid}")
        self._device[vid] = nbytes
        self._grow(nbytes)
        self._arena_alloc(vid, nbytes)

    def free(self, vid: int) -> None:
        b = self._device.pop(vid, None)
        if b is not None:
            self.stats.device_used -= b
            self.arena_release(vid)
        hb = self._host.pop(vid, None)
        if hb is not None:
            self.stats.host_used -= hb

    def hold(self, nbytes: int) -> None:
        """Count ``nbytes`` of unnamed device memory (a recompute
        sub-program's temporaries) until :meth:`release`."""
        self._grow(nbytes)

    def release(self, nbytes: int) -> None:
        self.stats.device_used -= nbytes

    # -- eviction paths -------------------------------------------------------
    def evict_to_host(self, vid: int) -> None:
        if self.fault_hook is not None:
            self.fault_hook("offload", vid, self._device.get(vid, 0))
        b = self._device.pop(vid)
        self.stats.device_used -= b
        self._host[vid] = b
        self.stats.host_used += b
        self.stats.host_peak = max(self.stats.host_peak, self.stats.host_used)
        self.stats.evictions += 1
        self.stats.evicted_bytes += b
        self.stats.offloads += 1
        self.arena_release(vid)

    def evict_drop(self, vid: int) -> None:
        """Eviction with recompute regeneration: bytes simply drop."""
        b = self._device.pop(vid)
        self.stats.device_used -= b
        self.stats.evictions += 1
        self.stats.evicted_bytes += b
        self.arena_release(vid)

    def reload(self, vid: int) -> None:
        if self.fault_hook is not None:
            self.fault_hook("reload", vid, self._host.get(vid, 0))
        b = self._host.pop(vid)
        self.stats.host_used -= b
        self._device[vid] = b
        self._grow(b)
        self.stats.reloads += 1
        self._arena_alloc(vid, b)

    def restore(self, vid: int, nbytes: int) -> None:
        """Re-allocation after recompute regeneration."""
        if self.fault_hook is not None:
            self.fault_hook("restore", vid, nbytes)
        self._device[vid] = nbytes
        self._grow(nbytes)
        self.stats.recomputes += 1
        self._arena_alloc(vid, nbytes)
