"""Runtime rematerialization decisions (paper §2.3 runtime half).

Port of ``repro/core/remat/runtime.py``.  When the memory limit is about
to be surpassed, choose which live candidate tensors to evict and how to
regenerate each (reload vs recompute), weighing memory savings against
end-to-end performance impact — the scoring follows the DELTA[10]-style
heuristic the paper cites: prefer victims with large bytes, cheap
regeneration, and distant next use.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from .planner import ExecutionPlan
from .search import (OFFLOAD_COST_PER_BYTE, RECOMPUTE_COST_PER_FLOP,
                     RELOAD_COST_PER_BYTE)


@dataclass
class EvictionDecision:
    vid: int
    method: str           # 'recompute' | 'offload'
    bytes_freed: int
    est_cost: float


class RuntimeRematPolicy:
    """Chooses victims among live candidates at an evict point."""

    def __init__(self, plan: ExecutionPlan, env: Dict[str, int]):
        self.plan = plan
        self.env = env
        self._flops_cache: Dict[int, int] = {}

    def _next_use_distance(self, vid: int, step: int) -> int:
        uses = self.plan.use_positions.get(vid, [])
        for u in uses:
            if u >= step:
                return u - step + 1
        return len(self.plan.order) - step + 1  # only needed for outputs/never

    def _regen_cost(self, vid: int, nbytes: int) -> Tuple[str, float]:
        cand = self.plan.candidates.get(vid)
        per_byte = RELOAD_COST_PER_BYTE + OFFLOAD_COST_PER_BYTE
        if cand is None or cand.recompute is None:
            return "offload", nbytes * per_byte
        # interval bounds may have fixed the method at compile time — skip
        # the symbolic flops evaluation entirely for statically-offload
        # candidates and keep only the (cached) cost lookup for recompute
        static = self.plan.static_methods.get(vid)
        if static == "offload":
            return "offload", nbytes * per_byte
        flops = self._flops_cache.get(vid)
        if flops is None:
            flops = max(1, cand.recompute.flops.evaluate(self.env))
            self._flops_cache[vid] = flops
        rc = flops * RECOMPUTE_COST_PER_FLOP
        if static == "recompute":
            return "recompute", rc
        ol = nbytes * per_byte
        return ("recompute", rc) if rc <= ol else ("offload", ol)

    def choose_victims(
        self,
        need_bytes: int,
        live_candidates: Dict[int, int],   # vid -> device bytes
        pinned: frozenset,                 # vids that must stay (current op)
        step: int,
    ) -> List[EvictionDecision]:
        scored: List[Tuple[float, EvictionDecision]] = []
        for vid, nbytes in live_candidates.items():
            if vid in pinned or nbytes <= 0:
                continue
            if vid not in self.plan.candidates:
                continue
            method, cost = self._regen_cost(vid, nbytes)
            dist = self._next_use_distance(vid, step)
            # DELTA-like: benefit-per-cost, discounted for imminent reuse
            score = (nbytes * dist) / (cost + 1.0)
            scored.append((score, EvictionDecision(vid, method, nbytes, cost)))
        scored.sort(key=lambda t: -t[0])
        out: List[EvictionDecision] = []
        freed = 0
        for _score, dec in scored:
            if freed >= need_bytes:
                break
            out.append(dec)
            freed += dec.bytes_freed
        return out
