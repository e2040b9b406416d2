"""Deployment Generator (paper §3.5): annotates the user's deployment
specification with placement hints, replica counts and data-staging plans
derived from the Knowledge Base, and instruments data accesses."""
from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.core.behavioral import EventModel
from repro_torch.core.knowledge_base import KnowledgeBase
from repro_torch.core.types import DeploymentSpec, FunctionSpec


class DeploymentGenerator:
    def __init__(self, kb: KnowledgeBase,
                 events: Optional[EventModel] = None):
        self.kb = kb
        self.events = events

    def annotate(self, spec: DeploymentSpec) -> DeploymentSpec:
        for fn in spec.functions:
            ann: Dict = dict(spec.annotations.get(fn.name, {}))
            hint = self.kb.best_platform(fn.name)
            if hint is not None:
                ann["preferred_platform"] = hint
            # initial replica count from the forecast arrival rate and the
            # benchmarked exec time (Little's law: L = lambda * W)
            if self.events is not None and hint is not None:
                bench = self.kb.benchmark(fn.name, hint) or {}
                w = bench.get("exec_p50", 0.1)
                lam = self.events.forecast_rate(fn.name)
                if lam > 0:
                    ann["min_replicas"] = max(1, math.ceil(lam * w))
            if fn.data_objects:
                ann["instrument_data_access"] = True
                ann["stage_objects"] = list(fn.data_objects)
            spec.annotations[fn.name] = ann
        return spec
