"""Runtime arena allocator (memory-planner stage 3).

Services the interpreter's alloc/free traffic through the planned slots.
The symbolic plan is realized per dim binding by ``ArenaPlan.resolve``
(slot sizes evaluated once per env, then the exact arena *reserve* for
that env computed by address-packing the planned lifetimes); the resolve
result is cached inside the plan alongside the interpreter's
``_size_cache``, so the whole arena could be reserved in one allocation up
front — TPU-style.  Per run the allocator:

* places caller-provided inputs/consts into their *external* slots (zero
  arena cost; with donation they join the reuse pool once dead, and
  values planned into them ride caller memory instead of the arena);
* puts each value into its assigned slot; when remat eviction has
  shuffled residency (a rematerialized tensor may find its slot taken),
  it falls back to best-fit over free slots or opens a dynamic slot — the
  arena cooperates with eviction and regeneration instead of constraining
  them.  If churn pushes live bytes past the planned reserve, the arena
  grows (``arena_growth_bytes``);
* tracks the stats surfaced on ``MemoryStats``: ``arena_bytes`` (final
  arena size for this env, growth included), ``slots``, ``reuse_ratio``
  (fraction of allocations served by a previously-used buffer),
  ``fragmentation_bytes`` (arena size minus the peak bytes simultaneously
  in use — the planner's waste vs a perfect allocator).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .assign import ArenaPlan, ResolvedArena


class ArenaExhausted(RuntimeError):
    """Arena occupancy crossed a hard cap the caller asked to enforce.

    Raised only under ``resilience.enforce_arena_bound``: the planner's
    ``arena_bound_bytes`` is a guarantee, so crossing it means runtime
    churn (remat realloc into foreign slots) grew the arena past what
    was promised — the degradation ladder treats it as memory pressure
    instead of letting the arena silently exceed the bound."""


class ArenaAllocator:
    def __init__(self, plan: ArenaPlan, resolved: ResolvedArena, *,
                 hard_cap: Optional[int] = None):
        self.plan = plan
        self.hard_cap = hard_cap
        self.capacity: List[int] = list(resolved.caps)
        self.external: List[bool] = list(resolved.external)
        n = len(self.capacity)
        self.occupant: List[Optional[int]] = [None] * n
        self.occupant_bytes: List[int] = [0] * n
        self.used_once: List[bool] = [False] * n
        self.slot_of: Dict[int, int] = {}    # vid -> sid currently holding it
        self.reserve = resolved.arena_bytes  # planned arena size for this env
        self.dynamic_slots = 0
        self.allocs = 0
        self.reuses = 0
        self.donated_reuses = 0
        self._in_use = 0                     # live bytes backed by the arena
        self.peak_in_use = 0

    # -- placement ------------------------------------------------------------
    def place_external(self, vid: int, nbytes: int) -> None:
        """Register a caller-provided buffer in its external slot."""
        if vid in self.slot_of:
            return
        asg = self.plan.assignment.get(vid)
        if asg is None or self.occupant[asg.sid] is not None:
            sid = self._new_slot(nbytes, external=True)
        else:
            sid = asg.sid
            self.capacity[sid] = nbytes   # the actual caller buffer size
        self._occupy(sid, vid, nbytes)

    def alloc(self, vid: int, nbytes: int) -> None:
        """Place a value; called for every device allocation (incl. remat
        restore/reload).  No-op if the value already holds a slot."""
        if vid in self.slot_of:
            return
        self.allocs += 1
        sid = None
        asg = self.plan.assignment.get(vid)
        if asg is not None and self.occupant[asg.sid] is None \
                and (not self.external[asg.sid]
                     or nbytes <= self.capacity[asg.sid]):
            sid = asg.sid
        if sid is None:
            sid = self._fallback_slot(nbytes)
        if sid is None:
            sid = self._new_slot(nbytes, external=False)
        if self.used_once[sid]:
            self.reuses += 1
            if self.external[sid]:
                self.donated_reuses += 1
        self._occupy(sid, vid, nbytes)

    def free(self, vid: int) -> None:
        sid = self.slot_of.pop(vid, None)
        if sid is None:
            return
        b = self.occupant_bytes[sid]
        self.occupant[sid] = None
        self.occupant_bytes[sid] = 0
        if not self.external[sid]:
            self._in_use -= b

    # -- internals -------------------------------------------------------------
    def _occupy(self, sid: int, vid: int, nbytes: int) -> None:
        self.occupant[sid] = vid
        self.occupant_bytes[sid] = nbytes
        self.slot_of[vid] = sid
        self.used_once[sid] = True
        if not self.external[sid]:
            self._in_use += nbytes
            if self.hard_cap is not None and self._in_use > self.hard_cap:
                # roll back before raising: the ladder may retry this call
                self.occupant[sid] = None
                self.occupant_bytes[sid] = 0
                del self.slot_of[vid]
                self._in_use -= nbytes
                raise ArenaExhausted(
                    f"arena occupancy {self._in_use + nbytes} would exceed "
                    f"the enforced bound of {self.hard_cap} bytes "
                    f"(value {vid}, {nbytes} bytes)")
            self.peak_in_use = max(self.peak_in_use, self._in_use)

    def _fallback_slot(self, nbytes: int) -> Optional[int]:
        """Best-fit among free slots: the smallest capacity that holds
        ``nbytes`` (external slots cannot stretch), else the roomiest
        arena slot — the pool serves any size."""
        best = best_cap = None
        roomiest = roomiest_cap = None
        for sid, occ in enumerate(self.occupant):
            if occ is not None:
                continue
            cap = self.capacity[sid]
            if cap >= nbytes and (best is None or cap < best_cap):
                best, best_cap = sid, cap
            if not self.external[sid] and \
                    (roomiest is None or cap > roomiest_cap):
                roomiest, roomiest_cap = sid, cap
        return best if best is not None else roomiest

    def _new_slot(self, nbytes: int, *, external: bool) -> int:
        sid = len(self.capacity)
        self.capacity.append(nbytes)
        self.external.append(external)
        self.occupant.append(None)
        self.occupant_bytes.append(0)
        self.used_once.append(False)
        if not external:
            self.dynamic_slots += 1
        return sid

    # -- reporting -------------------------------------------------------------
    @property
    def in_use_bytes(self) -> int:
        """Live bytes currently backed by the arena (externals excluded)."""
        return self._in_use

    @property
    def arena_bytes(self) -> int:
        """Final arena size: the planned reserve, grown if runtime churn
        (remat realloc into foreign slots) pushed live bytes past it."""
        return max(self.reserve, self.peak_in_use)

    @property
    def growth_bytes(self) -> int:
        return max(0, self.peak_in_use - self.reserve)

    @property
    def n_slots(self) -> int:
        """Arena-backed slots (external/donated buffers excluded)."""
        return sum(1 for ext in self.external if not ext)

    @property
    def reuse_ratio(self) -> float:
        return self.reuses / self.allocs if self.allocs else 0.0

    @property
    def fragmentation_bytes(self) -> int:
        return self.arena_bytes - self.peak_in_use

    def write_stats(self, stats) -> None:
        """Publish the run's arena counters onto a ``MemoryStats``."""
        stats.arena_bytes = self.arena_bytes
        stats.slots = self.n_slots
        stats.reuse_ratio = self.reuse_ratio
        stats.fragmentation_bytes = self.fragmentation_bytes
        stats.arena_growth_bytes = self.growth_bytes
        stats.donated_reuses = self.donated_reuses
