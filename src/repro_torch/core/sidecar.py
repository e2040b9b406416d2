"""Sidecar Controller (paper §3.2): the local half of the hierarchical
scheduling decision.

The control plane picks the *target platform*; the platform-local sidecar
(a) picks the node/replica (least-loaded first), and (b) for locally
triggered invocations decides whether to run locally or delegate up to the
control plane (when the local platform is under pressure or predicted to
violate the SLO).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.behavioral import FunctionPerformanceModel
from repro_torch.core.platform import TargetPlatform
from repro_torch.core.types import Invocation


class SidecarController:
    def __init__(self, platform: TargetPlatform,
                 perf: Optional[FunctionPerformanceModel] = None,
                 cpu_threshold: float = 0.95):
        self.platform = platform
        self.perf = perf
        self.cpu_threshold = cpu_threshold
        self.delegated = 0
        self.local = 0

    # node selection inside the platform --------------------------------
    def admit(self, inv: Invocation):
        """Control-plane-routed invocation: place onto this platform.

        Node choice is folded into the platform's replica picker (warm
        replicas first == least cold-start node); the sidecar records the
        decision for the knowledge base.
        """
        self.platform.invoke(inv)

    def admit_many(self, invs: Sequence[Invocation]):
        """Batched admission from the control plane's ``submit_batch``:
        the platform enqueues the whole group and drains once, instead of
        paying a full queue drain + metrics sample per invocation."""
        self.platform.invoke_batch(invs)

    def admit_columns(self, batch, idxs):
        """Columnar admission (``_submit_columns``): the platform queues
        the (batch, index-group) pair directly; ``Invocation`` objects
        appear only when the drain actually starts a row."""
        self.platform.invoke_columns(batch, idxs)

    # local trigger path -------------------------------------------------
    def _pressured(self) -> bool:
        p = self.platform
        return (p.failed or p.cpu_util() >= self.cpu_threshold
                or p.mem_util() >= 1.0)

    def _slo_risk(self, fn) -> bool:
        return (self.perf is not None and
                self.perf.predict_p90_response(fn, self.platform.prof)
                > fn.slo.p90_response_s)

    def handle_local_trigger(self, inv: Invocation,
                             delegate: Callable[[Invocation], None]):
        """§3.2: run locally unless pressure/SLO says delegate upward."""
        p = self.platform
        pressured = self._pressured()
        slo_risk = not pressured and self._slo_risk(inv.fn)
        if pressured or slo_risk or inv.fn.name not in p.deployed:
            self.delegated += 1
            delegate(inv)
        else:
            self.local += 1
            p.invoke(inv)

    def handle_local_triggers(self, invs: Sequence[Invocation],
                              delegate_batch: Callable[
                                  [Sequence[Invocation]], None]):
        """Batched §3.2 decision for a burst of locally triggered
        invocations: platform pressure is sampled once, SLO risk once per
        distinct function, and the burst splits into one local
        ``invoke_batch`` plus one upward ``delegate_batch`` — the local-
        trigger mirror of the control plane's grouped admission."""
        if not invs:
            return
        p = self.platform
        pressured = self._pressured()
        local: List[Invocation] = []
        delegated: List[Invocation] = []
        risk_by_fn: Dict[int, bool] = {}
        for inv in invs:
            fn = inv.fn
            if pressured or fn.name not in p.deployed:
                delegated.append(inv)
                continue
            risk = risk_by_fn.get(id(fn))
            if risk is None:
                risk = self._slo_risk(fn)
                risk_by_fn[id(fn)] = risk
            (delegated if risk else local).append(inv)
        self.delegated += len(delegated)
        self.local += len(local)
        if local:
            p.invoke_batch(local)
        if delegated:
            delegate_batch(delegated)
