"""Knowledge Base (paper §3.4): stores behavioral models, scheduling
decisions and benchmarking results; consulted by the DeploymentGenerator for
annotation of re-deployments and by external components (FDNInspector,
threshold tuning)."""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple


class KnowledgeBase:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.decisions: List[Dict] = []
        # log_decisions=False keeps only the counter: a 10^6-invocation
        # FDNInspector scenario must not grow a per-decision dict list
        self.log_decisions = True
        self.decision_count = 0
        self.benchmarks: Dict[Tuple[str, str], Dict] = {}
        self.models: Dict[str, Any] = {}
        if path and os.path.exists(path):
            self.load()

    # decisions ----------------------------------------------------------
    def record_decision(self, t: float, fn: str, platform: str,
                        policy: str, predicted_s: float):
        self.decision_count += 1
        if self.log_decisions:
            self.decisions.append({"t": t, "fn": fn, "platform": platform,
                                   "policy": policy,
                                   "predicted_s": predicted_s})

    def record_decisions(self, rows: List[Dict]):
        """Bulk append from the control plane's batched submit path."""
        self.decision_count += len(rows)
        if self.log_decisions:
            self.decisions.extend(rows)

    def count_decisions(self, n: int):
        """Row-free bookkeeping for un-logged batched decisions."""
        self.decision_count += n

    def best_platform(self, fn: str) -> Optional[str]:
        """Most frequent successful placement for fn (deployment hints)."""
        counts: Dict[str, int] = defaultdict(int)
        for d in self.decisions:
            if d["fn"] == fn:
                counts[d["platform"]] += 1
        if not counts:
            b = [(k[1], v) for k, v in self.benchmarks.items()
                 if k[0] == fn and "exec_p50" in v]
            if b:
                return min(b, key=lambda x: x[1]["exec_p50"])[0]
            return None
        return max(counts, key=counts.get)

    # benchmark results (from FDNInspector) ------------------------------
    def record_benchmark(self, fn: str, platform: str, stats: Dict):
        self.benchmarks[(fn, platform)] = dict(stats)

    def benchmark(self, fn: str, platform: str) -> Optional[Dict]:
        return self.benchmarks.get((fn, platform))

    # persistence --------------------------------------------------------
    def save(self):
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({"decisions": self.decisions,
                       "benchmarks": {f"{k[0]}|{k[1]}": v
                                      for k, v in self.benchmarks.items()}},
                      f)

    def load(self):
        with open(self.path) as f:
            data = json.load(f)
        self.decisions = data.get("decisions", [])
        self.benchmarks = {tuple(k.split("|")): v
                           for k, v in data.get("benchmarks", {}).items()}
