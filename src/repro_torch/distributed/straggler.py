"""Straggler detection & step-time health monitoring.

At 1000+ nodes slow hosts (thermal throttle, failing HBM, network
congestion) stretch every synchronous step.  The monitor keeps an EWMA +
variance of per-host step times, flags hosts whose times exceed a z-score
threshold for ``patience`` consecutive steps, and exposes the decision to
the launcher (which can drop the host and trigger an elastic restart from
the last checkpoint).

A copy of ``repro/distributed/straggler.py`` (framework-free); the
checkpoint's elastic re-shard restore is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Set


@dataclass
class StragglerConfig:
    z_threshold: float = 3.0
    patience: int = 3
    ewma_alpha: float = 0.1
    min_steps: int = 8


@dataclass
class HostStats:
    mean: float = 0.0
    var: float = 0.0
    count: int = 0
    strikes: int = 0


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.hosts: Dict[int, HostStats] = {}
        self.flagged: Set[int] = set()

    def record_step(self, times: Dict[int, float]) -> List[int]:
        """Record per-host step times; returns hosts newly flagged.

        A straggler is judged against the *fleet's* per-step distribution
        (median + MAD), never against its own history — a persistently slow
        host must not normalize itself.
        """
        if not times:
            return []
        vals = sorted(times.values())
        med = vals[len(vals) // 2]
        rels = {h: t / max(med, 1e-9) for h, t in times.items()}
        # robust spread of the healthy population (MAD -> sigma)
        healthy_rels = sorted(r for h, r in rels.items()
                              if h not in self.flagged)
        mad = sorted(abs(r - 1.0) for r in healthy_rels)[len(healthy_rels) // 2]
        sigma = max(mad * 1.4826, 1e-3)
        newly = []
        for host, t in times.items():
            st = self.hosts.setdefault(host, HostStats())
            a = self.cfg.ewma_alpha
            rel = rels[host]
            # per-host EWMA kept for drift telemetry
            if st.count == 0:
                st.mean, st.var = rel, 0.01
            else:
                d = rel - st.mean
                st.mean += a * d
                st.var = (1 - a) * (st.var + a * d * d)
            st.count += 1
            if st.count >= self.cfg.min_steps:
                z = (rel - 1.0) / sigma
                if z > self.cfg.z_threshold and rel > 1.1:
                    st.strikes += 1
                else:
                    st.strikes = 0
                if st.strikes >= self.cfg.patience and host not in self.flagged:
                    self.flagged.add(host)
                    newly.append(host)
        return newly

    def healthy_hosts(self, all_hosts: List[int]) -> List[int]:
        return [h for h in all_hosts if h not in self.flagged]
