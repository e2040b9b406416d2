"""Gateway: the FDN's single point of entry (the NGINX analogue of
§5.1.3), with access control and optional collaboration load-balancing in
front of the control plane's scheduler.

``request`` resolves the load-balancer target first and then calls
``cp.submit`` exactly once, so every invocation's arrival is recorded
exactly once in the behavioral models.  ``request_batch`` is the burst
path: one auth check and one policy evaluation for the whole batch.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.core.control_plane import FDNControlPlane
from repro_torch.core.invocation_batch import InvocationBatch
from repro_torch.core.scheduler import Policy
from repro_torch.core.types import Invocation


class Gateway:
    def __init__(self, cp: FDNControlPlane,
                 lb_policy: Optional[Policy] = None,
                 principal: str = "default", token: str = "secret"):
        self.cp = cp
        self.lb_policy = lb_policy
        cp.access.grant(principal, token)
        self.principal, self.token = principal, token
        self.unauthorized = 0
        # principal -> tenant id: multi-tenant ingress stamping (QoS
        # layer); empty dict keeps both request paths at one falsy check
        self.tenants: Dict[str, int] = {}

    def set_tenant(self, principal: str, tenant: int):
        """Map an authenticated principal to a tenant id: every
        invocation arriving under that principal is stamped with the
        tenant before admission (the per-tenant column the QoS fairness
        and shed-rate report sections aggregate over)."""
        self.tenants[principal] = int(tenant)

    def _stamp_tenant(self, invs, principal: Optional[str]):
        tenant = self.tenants.get(
            principal if principal is not None else self.principal)
        if tenant is None:
            return
        if isinstance(invs, InvocationBatch):
            invs.tenant[:] = tenant
        else:
            for inv in invs:
                inv.tenant = tenant

    def _authorized(self, principal: Optional[str],
                    token: Optional[str]) -> bool:
        principal = principal if principal is not None else self.principal
        token = token if token is not None else self.token
        return self.cp.access.check(principal, token)

    def request(self, inv: Invocation, principal: Optional[str] = None,
                token: Optional[str] = None) -> bool:
        if not self._authorized(principal, token):
            self.unauthorized += 1
            inv.status = "failed"
            rec = self.cp.recorder
            if rec is not None:
                rec.record_reject(inv.fn.name, None, self.cp.clock.now(), 1)
            return False
        if self.tenants:
            self._stamp_tenant((inv,), principal)
        override = None
        if self.lb_policy is not None:
            target = self.lb_policy.choose(inv, self.cp.alive_platforms())
            if target is not None:
                override = target.prof.name
        return self.cp.submit(inv, platform_override=override)

    def request_batch(self, invs: Sequence[Invocation],
                      principal: Optional[str] = None,
                      token: Optional[str] = None) -> int:
        """Admit a whole arrival burst: auth once, route once, submit in
        per-platform groups.  Accepts a plain sequence or an
        ``InvocationBatch`` (columnar batches pass straight through to the
        control plane; a gateway load-balancer needs object rows).
        Returns the number of accepted invocations."""
        if not len(invs):
            return 0
        if not self._authorized(principal, token):
            self.unauthorized += len(invs)
            if isinstance(invs, InvocationBatch):
                invs.state[:] = InvocationBatch.REJECTED
            else:
                for inv in invs:
                    inv.status = "failed"
            rec = self.cp.recorder
            if rec is not None:
                rec.record_reject(None, None, self.cp.clock.now(),
                                  len(invs))
            return 0
        if self.tenants:
            self._stamp_tenant(invs, principal)
        if self.lb_policy is None:
            return self.cp.submit_batch(invs)
        if isinstance(invs, InvocationBatch):
            invs = invs.to_invocations()
        targets = self.lb_policy.choose_batch(invs,
                                              self.cp.alive_platforms())
        groups: Dict[str, List[Invocation]] = {}
        unrouted: List[Invocation] = []
        for inv, target in zip(invs, targets):
            if target is None:
                unrouted.append(inv)
            else:
                groups.setdefault(target.prof.name, []).append(inv)
        accepted = 0
        for pname, group in groups.items():
            accepted += self.cp.submit_batch(group, platform_override=pname)
        if unrouted:       # fall back to the scheduler, still a single path
            accepted += self.cp.submit_batch(unrouted)
        return accepted
