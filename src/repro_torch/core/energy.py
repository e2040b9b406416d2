"""Energy accounting (paper §5.2, Table 4).

Per-platform power model: P(t) = nodes * (idle + (loaded - idle) * util(t))
plus a warm-pool keep-alive term: every *idle* warm replica burns
``warm_w_per_replica`` watts (container resident in memory, runtime pinned
— the idle-watt side of the cold-start/energy trade-off the autoscaler
navigates; 0 by default, so platforms without a configured keep-alive cost
are unchanged).  The meter integrates piecewise-constant utilization and
idle-pool size on the sim clock, so ``joules(platform)`` reproduces the
paper's "average power x duration" measurements (RAPL on the HPC sockets,
POM_5V_CPU rails on the Jetsons), and ``keepalive_joules`` isolates what
the warm pools cost.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from repro_torch.core.types import PlatformProfile


class EnergyMeter:
    def __init__(self):
        self._last_t: Dict[str, float] = {}
        self._last_util: Dict[str, float] = {}
        self._last_idle: Dict[str, int] = {}
        self._joules: Dict[str, float] = defaultdict(float)
        self._busy_joules: Dict[str, float] = defaultdict(float)
        self._keepalive_joules: Dict[str, float] = defaultdict(float)
        self._profiles: Dict[str, PlatformProfile] = {}

    def register(self, prof: PlatformProfile, t: float = 0.0):
        self._profiles[prof.name] = prof
        self._last_t[prof.name] = t
        self._last_util[prof.name] = 0.0
        self._last_idle[prof.name] = 0

    def power_w(self, name: str, util: float) -> float:
        p = self._profiles[name]
        util = min(max(util, 0.0), 1.0)
        return p.nodes * (p.idle_w_per_node +
                          (p.loaded_w_per_node - p.idle_w_per_node) * util)

    def update(self, name: str, t: float, util: float,
               idle_warm: Optional[int] = None):
        """Advance to time t with the utilization (and idle warm-pool
        size) held since the last update.  ``idle_warm=None`` keeps the
        previous pool size (legacy callers that only know utilization)."""
        lt = self._last_t.get(name, t)
        lu = self._last_util.get(name, 0.0)
        if t > lt:
            dt = t - lt
            self._joules[name] += self.power_w(name, lu) * dt
            dyn = self.power_w(name, lu) - self.power_w(name, 0.0)
            self._busy_joules[name] += dyn * dt
            w = self._profiles[name].warm_w_per_replica
            if w > 0.0:
                keep = w * self._last_idle.get(name, 0) * dt
                self._keepalive_joules[name] += keep
                self._joules[name] += keep
        self._last_t[name] = t
        self._last_util[name] = util
        if idle_warm is not None:
            self._last_idle[name] = idle_warm

    def joules(self, name: str) -> float:
        return self._joules[name]

    def dynamic_joules(self, name: str) -> float:
        return self._busy_joules[name]

    def keepalive_joules(self, name: str) -> float:
        """Energy spent holding idle replicas warm (idle-Wh numerator)."""
        return self._keepalive_joules[name]

    def table(self) -> List[Tuple[str, float, float, float]]:
        """(platform, idle W, loaded W, total J) rows — Table 4 shape."""
        out = []
        for name, p in self._profiles.items():
            out.append((name, p.nodes * p.idle_w_per_node,
                        p.nodes * p.loaded_w_per_node, self._joules[name]))
        return out
