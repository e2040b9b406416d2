"""FDN Control Plane (paper §3.1): the joint management layer over all
target platforms — access control, monitoring, hierarchical scheduling,
data placement, fault tolerance, and elastic platform membership.

Flow per invocation (Fig. 3): Gateway -> access control -> Scheduler policy
chooses the target platform -> that platform's SidecarController admits it
locally -> completion feeds Monitoring + Behavioral models + KnowledgeBase.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.behavioral import (EventModel, FunctionPerformanceModel,
                                         InteractionModel)
from repro_torch.core.data_placement import DataPlacementManager
from repro_torch.core.energy import EnergyMeter
from repro_torch.core.faults import FailureDetector, HedgePolicy, Redeliverer
from repro_torch.core.invocation_batch import InvocationBatch
from repro_torch.core.knowledge_base import KnowledgeBase
from repro_torch.core.monitoring import MetricsRegistry
from repro_torch.core.platform import TargetPlatform
from repro_torch.core.scheduler import Policy, SLOCompositePolicy, as_snapshot
from repro_torch.core.sidecar import SidecarController
from repro_torch.core.simulator import SimClock
from repro_torch.core.types import DeploymentSpec, FunctionSpec, Invocation


class AccessControl:
    """§3.1.1 — per-platform credentials; deny unknown principals."""

    def __init__(self):
        self._tokens: Dict[str, str] = {}

    def grant(self, principal: str, token: str):
        self._tokens[principal] = token

    def check(self, principal: str, token: str) -> bool:
        return self._tokens.get(principal) == token


@dataclass
class AdmissionRequest:
    """THE admission surface: every entry point — scalar ``submit``,
    object-list ``submit_batch``, columnar ``_submit_columns`` — wraps
    its arguments into one of these and hands it to
    ``FDNControlPlane.admit``.  ``invs`` is either a sequence of
    ``Invocation`` objects (a single invocation travels as a batch of
    one) or an ``InvocationBatch``; QoS class and tenant ride the
    invocations/columns themselves, so they enter the plane exactly
    once, here."""

    invs: Union[Sequence[Invocation], InvocationBatch]
    platform_override: Optional[str] = None


class FDNControlPlane:
    def __init__(self, clock: Optional[SimClock] = None,
                 policy: Optional[Policy] = None,
                 enable_hedging: bool = False,
                 predictive_prewarm: bool = False,
                 kb_path: Optional[str] = None,
                 retain_completions: bool = True):
        self.clock = clock or SimClock()
        self.metrics = MetricsRegistry()
        self.energy = EnergyMeter()
        self.placement = DataPlacementManager()
        self.perf = FunctionPerformanceModel()
        self.events = EventModel()
        self.interactions = InteractionModel()
        self.kb = KnowledgeBase(kb_path)
        self.access = AccessControl()
        self.platforms: Dict[str, TargetPlatform] = {}
        self.sidecars: Dict[str, SidecarController] = {}
        self.policy: Policy = policy or SLOCompositePolicy(
            self.perf, self.placement)
        self.detector = FailureDetector(self.clock)
        self.redeliverer = Redeliverer()
        self.hedge = HedgePolicy(self.clock, self.perf,
                                 enabled=enable_hedging)
        self.predictive_prewarm = predictive_prewarm
        # warm-pool lifecycle control loop (repro_torch.autoscale); None
        # until attach_autoscaler — platforms then manage their own
        # keep-alive via the legacy faas-idler
        self.autoscaler = None
        # flight recorder (repro_torch.obs); None until attach_recorder —
        # every tap in the admission paths guards on it with one check per
        # burst
        self.recorder = None
        self._hedge_tap = False
        # live telemetry engine (repro_torch.obs.telemetry); None until
        # attach_telemetry — metrics-ingest and platform-health taps all
        # guard on it with one ``is None`` check
        self.telemetry = None
        # QoS layer (repro_torch.core.qos); None until attach_qos — the admit
        # core consults the admission controller with one ``is None``
        # check per request
        self.qos = None
        self.admission = None
        # decision journal (repro_torch.obs.provenance); None until
        # attach_provenance — the fused-decision sites guard on it with
        # one ``is None`` check per burst, so provenance-off admission
        # costs nothing per invocation
        self.journal = None
        # retain_completions=False drops the per-invocation completed and
        # rejected lists (open-loop sinks own the samples; 10^6-invocation
        # scenarios must not retain a million Invocation objects here)
        self.retain_completions = retain_completions
        self.completed_count = 0
        self.rejected_count = 0
        self.completed: List[Invocation] = []
        self.rejected: List[Invocation] = []

    # ------------------------------------------------- platform lifecycle -
    def create_platform(self, prof, **kw) -> TargetPlatform:
        """Factory wiring the platform to this control plane's substrate."""
        p = TargetPlatform(prof, self.clock, self.metrics, self.energy,
                           placement=self.placement, **kw)
        return self.add_platform(p)

    def add_platform(self, platform: TargetPlatform) -> TargetPlatform:
        """Elastic membership: platforms may join at any time."""
        name = platform.prof.name
        self.platforms[name] = platform
        self.sidecars[name] = SidecarController(platform, self.perf)
        platform.placement = platform.placement or self.placement
        platform.metrics = self.metrics
        if platform.energy is not self.energy:
            platform.energy = self.energy
            self.energy.register(platform.prof, self.clock.now())
        if name not in self.placement.stores:
            self.placement.add_store(name)
        platform.on_complete.append(self._on_complete)
        platform.on_fail.append(self._on_fail)
        platform.recorder = self.recorder
        platform.telemetry = self.telemetry
        if self.qos is not None:
            platform.set_qos(self.qos)
        self.detector.heartbeat(name)
        self._schedule_heartbeat(platform)
        if self.autoscaler is not None:
            self.autoscaler.adopt(platform)
        return platform

    def _schedule_heartbeat(self, platform: TargetPlatform):
        """Platforms self-report liveness on the clock; a failed platform
        stops beating and the detector ejects it (§3.1.3 Fault Tolerance)."""
        name = platform.prof.name

        def beat():
            if self.platforms.get(name) is not platform:
                return                      # removed (elastic scale-in)
            if not platform.failed:
                self.detector.heartbeat(name)
            else:
                self.detector.check(name)   # accrue suspicion -> eject
            tel = self.telemetry
            if tel is not None:
                # periodic health sample even when the platform is idle
                # or failed (drain-side taps go quiet in both states)
                platform.sample_health(tel)
            self.clock.after(self.detector.interval, beat)

        self.clock.after(self.detector.interval, beat)

    def remove_platform(self, name: str):
        """Elastic scale-in (drain is the caller's concern)."""
        self.platforms.pop(name, None)
        self.sidecars.pop(name, None)

    def alive_platforms(self) -> List[TargetPlatform]:
        return [p for name, p in self.platforms.items()
                if not p.failed and self.detector.check(name)]

    # ----------------------------------------------------------- deploy ---
    def deploy(self, spec: DeploymentSpec):
        for fn in spec.functions:
            for pname in spec.target_platforms:
                if pname in self.platforms:
                    self.platforms[pname].deploy(fn)
            stage = spec.annotations.get(fn.name, {}).get("stage_objects")
            pref = spec.annotations.get(fn.name, {}).get(
                "preferred_platform")
            if stage and pref:
                self.placement.stage_for(fn.name, stage, pref)

    # ------------------------------------------------------------ submit --
    def _record_arrival(self, inv: Invocation, now: float):
        """Arrival bookkeeping, exactly once per invocation: redelivery and
        gateway fall-through must not double-count in the EventModel /
        InteractionModel."""
        if inv.arrival_recorded:
            return
        inv.arrival_recorded = True
        self.events.record(inv.fn.name, now)
        self.interactions.record(inv.fn.name, now)

    def submit(self, inv: Invocation,
               platform_override: Optional[str] = None) -> bool:
        """Deprecated shim: wraps the invocation into an
        ``AdmissionRequest`` batch of one and routes it through the
        unified ``admit`` core.  Decisions, knowledge-base rows, hedge
        timers and queue timings are byte-identical to the historical
        scalar body (the parity tests pin batch-of-1 against sequential
        submits).  Returns True iff the invocation was admitted
        somewhere."""
        return self.admit(AdmissionRequest((inv,), platform_override)) > 0

    def admit(self, req: AdmissionRequest) -> int:
        """THE admission core (every legacy entry point is a shim over
        this): consult the QoS admission controller once — token
        buckets, overload shed/degrade/spillover, brownout — then route
        the survivors down the columnar or object path, and any
        spillover rows to their override platform *after* the main
        rows.  With no controller attached the gate costs one ``is
        None`` check.  Returns the number of admitted invocations."""
        invs = req.invs
        columnar = isinstance(invs, InvocationBatch)
        n = invs.n if columnar else len(invs)
        if n == 0:
            return 0
        adm = self.admission
        spill = None
        if adm is not None:
            if columnar:
                invs, spill = adm.gate_columns(self, invs)
            else:
                invs, spill = adm.gate_objects(self, invs)
        accepted = 0
        if columnar:
            if invs is not None and invs.n:
                accepted = self._admit_columns(invs,
                                               req.platform_override)
        elif invs:
            accepted = self._admit_objects(invs, req.platform_override)
        if spill is not None:
            accepted += self._admit_objects(spill[0], spill[1])
        return accepted

    def _admit_one(self, inv: Invocation,
                   platform_override: Optional[str] = None) -> bool:
        """Scalar admission body (the object path's batch-of-1 fast
        path — same decisions as the grouped path, pinned by tests; no
        grouping/snapshot overhead for closed-loop callers)."""
        self._record_arrival(inv, self.clock.now())
        if self.predictive_prewarm:
            self._maybe_prewarm(inv.fn)
        if platform_override is not None:
            target = self.platforms.get(platform_override)
        elif self.journal is None:
            target = self.policy.choose(inv, self.alive_platforms())
        else:
            # journaled scalar path: same decision as ``choose`` (one
            # fused fn_decisions over the same snapshot), plus one
            # provenance row stamped onto the invocation
            snap = as_snapshot(self.alive_platforms())
            res = self.policy.fn_decisions([inv.fn], snap)
            if res is None:                 # stateful: never journaled
                target = self.policy.choose(inv, snap)
            else:
                idx, ok = res
                rowids = self.journal.record(
                    self.clock.now(), [inv.fn], snap, idx, ok,
                    np.ones(1, np.int32))
                inv.decision = int(rowids[0])
                target = snap.platforms[int(idx[0])] if ok[0] else None
        rec = self.recorder
        if target is None:
            inv.status = "failed"
            self._reject(inv)
            if rec is not None:
                rec.record_reject(inv.fn.name, None, self.clock.now(), 1)
            return False
        self.kb.record_decision(
            self.clock.now(), inv.fn.name, target.prof.name,
            self.policy.name, self.perf.predict_exec(inv.fn, target.prof))
        if rec is not None:
            rec.record_admit(inv.fn.name, target.prof.name,
                             self.clock.now(), 1)
        self.sidecars[target.prof.name].admit(inv)
        if self.hedge.enabled:
            alternates = [p for p in self.alive_platforms()
                          if p is not target]
            self.hedge.watch(inv, target, alternates,
                             lambda i, p: self.sidecars[p.prof.name].admit(i))
        return True

    def submit_batch(self,
                     invs: Union[Sequence[Invocation], InvocationBatch],
                     platform_override: Optional[str] = None) -> int:
        """Admit a whole arrival batch in ONE fused policy evaluation.

        Accepts either a sequence of ``Invocation`` objects or an
        ``InvocationBatch`` (struct-of-arrays).  The columnar form routes
        through ``_submit_columns`` — same decisions, same admission
        order, but no per-arrival Python object until a replica actually
        starts one.

        One pass groups the batch by distinct function and folds the
        arrival bookkeeping (rate model counts, co-invocation edges) into
        bulk updates; the policy then makes one fused decision per
        (function, platform-set) — the jitted cascade + argmin of
        ``scheduler.fn_decisions`` — instead of scoring an (N, P) matrix
        row per invocation (stateful rotation policies keep the full-
        matrix path).  Decisions are logged to the knowledge base in bulk,
        each target platform drains its queue once per batch, and with
        hedging enabled ONE vectorized hedge timer is armed per
        (fn, platform) admission group rather than per invocation.

        Platform choices are identical to per-invocation ``submit`` calls
        (tests pin this).  Queue order inside ONE batch: arrivals in a
        batch share a timestamp, so with knowledge-base row logging off
        (the production config) admission is grouped per distinct
        function — a deterministic tie-break between simultaneous
        arrivals; with logging on, strict arrival order is kept and the
        logged rows match sequential submits row for row.  Returns the
        number of accepted invocations; rejected ones land in
        ``self.rejected``.

        Deprecated shim: this is now a thin adapter over the unified
        ``admit`` core (where QoS admission control runs once for every
        entry point).
        """
        return self.admit(AdmissionRequest(invs, platform_override))

    def _admit_objects(self,
                       invs: Sequence[Invocation],
                       platform_override: Optional[str] = None) -> int:
        """Object-path admission body (see ``submit_batch`` for the
        grouped-decision semantics; ``admit`` has already run the QoS
        gate by the time this is called)."""
        if len(invs) == 1:
            return 1 if self._admit_one(invs[0], platform_override) else 0
        now = self.clock.now()
        # one pass: distinct-function grouping (mirror of
        # scheduler.group_by_fn — identity-keyed, first-appearance order;
        # keep the two in sync) fused with arrival bookkeeping (exactly
        # once per invocation, rate-model counts folded per fn)
        groups: List[Tuple[FunctionSpec, List[int]]] = []
        gmap: Dict[int, Tuple[FunctionSpec, List[int]]] = {}
        fn_counts: Dict[str, int] = {}
        new_names: List[str] = []
        for i, inv in enumerate(invs):
            fn = inv.fn
            g = gmap.get(id(fn))
            if g is None:
                g = (fn, [i])
                gmap[id(fn)] = g
                groups.append(g)
            else:
                g[1].append(i)
            if not inv.arrival_recorded:
                inv.arrival_recorded = True
                name = fn.name
                fn_counts[name] = fn_counts.get(name, 0) + 1
                new_names.append(name)
        for name, c in fn_counts.items():
            self.events.record_many(name, now, c)
        self.interactions.record_batch(new_names, now)
        if self.predictive_prewarm:
            seen: Dict[str, FunctionSpec] = {}
            for fn, _idxs in groups:
                seen.setdefault(fn.name, fn)
            for fn in seen.values():
                self._maybe_prewarm(fn)

        alive = self.alive_platforms()
        n = len(invs)
        # per-GROUP routing: (fn, idxs, target) — valid whenever every
        # invocation of a function shares one decision (fused decisions
        # and overrides); None for stateful per-row policies
        fast: Optional[List[Tuple[FunctionSpec, List[int],
                                  Optional[TargetPlatform]]]] = None
        targets: Optional[List[Optional[TargetPlatform]]] = None
        if platform_override is not None:
            ov = self.platforms.get(platform_override)
            fast = [(fn, idxs, ov) for fn, idxs in groups]
        else:
            snap = as_snapshot(alive)
            res = self.policy.fn_decisions([g[0] for g in groups], snap)
            if res is None:                 # stateful policy: full matrix
                targets = self.policy.choose_batch(invs, snap)
            else:
                idx, ok = res
                plats = snap.platforms
                fast = [(fn, idxs,
                         plats[int(idx[g])] if ok[g] else None)
                        for g, (fn, idxs) in enumerate(groups)]
                if self.journal is not None:
                    rowids = self.journal.record(
                        now, [g[0] for g in groups], snap, idx, ok,
                        np.array([len(g[1]) for g in groups], np.int32))
                    for g, (_fn, idxs) in enumerate(groups):
                        rid = int(rowids[g])
                        for i in idxs:
                            invs[i].decision = rid

        accepted = 0
        rec = self.recorder
        pname_groups: Dict[str, List[Invocation]] = {}
        # (target, members) per (fn, platform) — ONE hedge timer each
        hedge_groups: List[Tuple[TargetPlatform, List[Invocation]]] = []
        log_decisions = self.kb.log_decisions
        want_hedges = self.hedge.enabled
        if fast is not None and not log_decisions:
            # production path: admission grouped per distinct function
            # (arrivals inside one batch are simultaneous — group order
            # is the documented deterministic tie-break)
            for fn, idxs, target in fast:
                if target is None:
                    for i in idxs:
                        inv = invs[i]
                        inv.status = "failed"
                        self._reject(inv)
                    if rec is not None:
                        rec.record_reject(fn.name, None, now, len(idxs))
                    continue
                members = [invs[i] for i in idxs]
                if rec is not None:
                    rec.record_admit(fn.name, target.prof.name, now,
                                     len(members))
                if want_hedges:
                    hedge_groups.append((target, members))
                pname = target.prof.name
                group = pname_groups.get(pname)
                if group is None:
                    # hedge groups keep `members` — hand the platform
                    # group a copy so later extends don't alias into it
                    pname_groups[pname] = members[:] if want_hedges \
                        else members
                else:
                    group.extend(members)
                accepted += len(members)
            self.kb.count_decisions(accepted)
        else:
            # debug/stateful path: strict arrival order (knowledge-base
            # rows match sequential submits row for row)
            if targets is None:
                targets = [None] * n
                for fn, idxs, target in fast:
                    if target is not None:
                        for i in idxs:
                            targets[i] = target
            pred_cache: Dict[Tuple[str, str], float] = {}
            rows: List[Dict] = []
            policy_name = self.policy.name
            hgroups: Dict[Tuple[int, str],
                          Tuple[TargetPlatform, List[Invocation]]] = {}
            admit_counts: Dict[Tuple[str, str], int] = {}
            for inv, target in zip(invs, targets):
                if target is None:
                    inv.status = "failed"
                    self._reject(inv)
                    if rec is not None:
                        rec.record_reject(inv.fn.name, None, now, 1)
                    continue
                pname = target.prof.name
                if rec is not None:
                    akey = (inv.fn.name, pname)
                    admit_counts[akey] = admit_counts.get(akey, 0) + 1
                if log_decisions:
                    key = (inv.fn.name, pname)
                    pred = pred_cache.get(key)
                    if pred is None:
                        pred = self.perf.predict_exec(inv.fn, target.prof)
                        pred_cache[key] = pred
                    rows.append({"t": now, "fn": inv.fn.name,
                                 "platform": pname, "policy": policy_name,
                                 "predicted_s": pred})
                group = pname_groups.get(pname)
                if group is None:
                    pname_groups[pname] = [inv]
                else:
                    group.append(inv)
                if want_hedges:
                    hkey = (id(inv.fn), pname)
                    entry = hgroups.get(hkey)
                    if entry is None:
                        hgroups[hkey] = (target, [inv])
                    else:
                        entry[1].append(inv)
                accepted += 1
            if log_decisions:
                self.kb.record_decisions(rows)
            else:
                self.kb.count_decisions(accepted)
            if rec is not None:
                for (fname, pname), c in admit_counts.items():
                    rec.record_admit(fname, pname, now, c)
            hedge_groups.extend(hgroups.values())

        for pname, group in pname_groups.items():
            self.sidecars[pname].admit_many(group)
        if want_hedges:
            alt_cache: Dict[str, List[TargetPlatform]] = {}
            for target, members in hedge_groups:
                pname = target.prof.name
                alternates = alt_cache.get(pname)
                if alternates is None:
                    alternates = [p for p in alive if p is not target]
                    alt_cache[pname] = alternates
                self.hedge.watch_group(members, target, alternates,
                                       self._admit_hedges)
        return accepted

    def _submit_columns(self, batch: InvocationBatch,
                        platform_override: Optional[str] = None) -> int:
        """Deprecated shim over the unified ``admit`` core (kept because
        callers and tests address the columnar path by this name)."""
        return self.admit(AdmissionRequest(batch, platform_override))

    def _admit_columns(self, batch: InvocationBatch,
                       platform_override: Optional[str] = None) -> int:
        """Array-native ``submit_batch``: decide and route straight off
        the batch's columns.

        Arrival bookkeeping is one bincount + one columnar interaction
        fold; the policy makes one fused decision per distinct function
        present (``present_fns`` keeps the object path's first-appearance
        group order, so per-platform admission order — and therefore
        every queue timing — is identical to submitting the materialized
        objects).  Paths that need real objects (decision-row logging,
        hedging, stateful per-row policies) fall back to the object path
        wholesale.  Platform targets receive ``admit_columns`` index
        groups; ``Invocation`` objects only materialize when a replica
        starts (or for retained rejections).
        """
        if batch.n == 0:
            return 0
        if self.kb.log_decisions or self.hedge.enabled:
            # object-path fallback must NOT re-enter admit(): the QoS
            # gate already ran for these rows
            return self._admit_objects(batch.to_invocations(),
                                       platform_override)
        now = self.clock.now()
        specs = batch.specs
        fidx = batch.fn_idx
        if not batch.arrival_recorded:
            batch.arrival_recorded = True
            counts = np.bincount(fidx, minlength=len(specs))
            for j, c in enumerate(counts):
                if c:
                    self.events.record_many(specs[j].name, now, int(c))
            self.interactions.record_batch_columns(
                fidx, [s.name for s in specs], now)
        present = batch.present_fns()
        pres_specs = [specs[int(j)] for j in present]
        if self.predictive_prewarm:
            seen: Dict[str, FunctionSpec] = {}
            for fn in pres_specs:
                seen.setdefault(fn.name, fn)
            for fn in seen.values():
                self._maybe_prewarm(fn)

        if platform_override is not None:
            ov = self.platforms.get(platform_override)
            tmap: List[Optional[TargetPlatform]] = [ov] * len(present)
        else:
            snap = as_snapshot(self.alive_platforms())
            res = self.policy.fn_decisions(pres_specs, snap)
            if res is None:             # stateful policy: needs real rows
                invs = batch.to_invocations()
                for inv in invs:        # bookkeeping already folded above
                    inv.arrival_recorded = True
                return self._admit_objects(invs, platform_override)
            idx, ok = res
            plats = snap.platforms
            tmap = [plats[int(idx[g])] if ok[g] else None
                    for g in range(len(present))]
            if self.journal is not None:
                cnt = np.bincount(fidx, minlength=len(specs))
                rowids = self.journal.record(now, pres_specs, snap,
                                             idx, ok, cnt[present])

        accepted = 0
        rec = self.recorder
        pname_groups: Dict[str, List[np.ndarray]] = {}
        for g, j in enumerate(present):
            target = tmap[g]
            idxs = np.nonzero(fidx == j)[0]
            if self.journal is not None and platform_override is None:
                batch.decision[idxs] = rowids[g]
            if target is None:
                batch.state[idxs] = InvocationBatch.REJECTED
                self.rejected_count += int(idxs.size)
                if self.retain_completions:
                    for i in idxs:
                        inv = batch.materialize(int(i))
                        inv.status = "failed"
                        self.rejected.append(inv)
                if rec is not None:
                    rec.record_reject(pres_specs[g].name, None, now,
                                      int(idxs.size))
                continue
            batch.state[idxs] = InvocationBatch.ADMITTED
            if rec is not None:
                rec.record_admit(pres_specs[g].name, target.prof.name,
                                 now, int(idxs.size))
            group = pname_groups.get(target.prof.name)
            if group is None:
                pname_groups[target.prof.name] = [idxs]
            else:
                group.append(idxs)
            accepted += int(idxs.size)
        self.kb.count_decisions(accepted)
        for pname, parts in pname_groups.items():
            idxs = parts[0] if len(parts) == 1 else np.concatenate(parts)
            self.sidecars[pname].admit_columns(batch, idxs)
        return accepted

    def _admit_hedges(self, dups: List[Invocation],
                      platform: TargetPlatform):
        """Batch-admit speculative duplicates at their alternate platform
        (hedge traffic bypasses arrival recording, like the scalar path)."""
        self.sidecars[platform.prof.name].admit_many(dups)

    def _reject(self, inv: Invocation):
        self.rejected_count += 1
        if self.retain_completions:
            self.rejected.append(inv)

    # ---------------------------------------------------------- feedback --
    def _on_complete(self, inv: Invocation):
        self.perf.observe(inv)
        self.hedge.completed(inv)
        self.completed_count += 1
        if self.retain_completions:
            self.completed.append(inv)

    def _on_fail(self, inv: Invocation):
        self.redeliverer.handle_failure(
            inv, lambda i: self.submit(i))

    def _maybe_prewarm(self, fn: FunctionSpec):
        """§3.3(1): start containers ahead of the forecast workload."""
        rate = self.events.forecast_rate(fn.name)
        if rate <= 0:
            return
        target = self.policy.choose(Invocation(fn, self.clock.now()),
                                    self.alive_platforms())
        if target is None:
            return
        w = self.perf.predict_exec(fn, target.prof)
        want = int(rate * w) + 1
        have = target.replica_count(fn.name)
        if want > have:
            n = min(want - have, 8)
            target.prewarm(fn.name, n)
            rec = self.recorder
            if rec is not None:
                rec.record_prewarm(target.prof.name, fn.name,
                                   self.clock.now(), n)

    # -------------------------------------------------------- autoscale ---
    def attach_autoscaler(self, policy: str = "predictive",
                          tick_s: float = 1.0,
                          backend: Optional[str] = None,
                          policy_kwargs: Optional[Dict] = None,
                          start: bool = True):
        """Attach the warm-pool lifecycle controller
        (repro_torch.autoscale): takes over keep-alive from every
        platform's faas-idler and drives prewarm/retire pool transitions
        from the named keep-alive policy ("ttl" | "scale_to_zero" |
        "concurrency" | "predictive")."""
        from repro_torch.autoscale import WarmPoolController, make_policy
        kw = dict(policy_kwargs or {})
        if backend is not None:
            kw["backend"] = backend
        self.autoscaler = WarmPoolController(
            self.platforms, self.perf, self.clock,
            make_policy(policy, **kw), tick_s=tick_s).attach()
        self.autoscaler.recorder = self.recorder
        if start:
            self.autoscaler.start()
        return self.autoscaler

    # ----------------------------------------------------- observability --
    def attach_recorder(self, recorder):
        """Attach a flight recorder (repro_torch.obs) plane-wide: admission
        taps here, launch taps at every platform, warm-pool taps at the
        autoscaler, and a hedge-duplicate tap on the hedge policy."""
        self.recorder = recorder
        for p in self.platforms.values():
            p.recorder = recorder
        if self.autoscaler is not None:
            self.autoscaler.recorder = recorder
        if not self._hedge_tap:
            self._hedge_tap = True

            def _hedge_span(orig, dup):
                rec = self.recorder
                if rec is not None:
                    rec.record_hedge(dup, orig, self.clock.now())

            self.hedge.on_duplicate.append(_hedge_span)
        return recorder

    def attach_provenance(self, journal):
        """Attach a decision journal (repro_torch.obs.provenance): every
        fused ``fn_decisions`` admission records one provenance row per
        distinct function — snapshot feature columns, filter-kill
        bitmask, chosen/runner-up slots and margin — and stamps the row
        id onto the routed invocations for the completion join.  Binds
        the live policy's cascade + params and this plane's perf and
        placement models; rows routed by overrides, spillover, hedging
        or stateful rotation policies are never journaled (their
        ``decision`` stays -1)."""
        self.journal = journal.bind(self.policy, self.perf,
                                    self.placement)
        return journal

    def attach_telemetry(self, engine):
        """Attach a live telemetry engine (repro_torch.obs.telemetry)
        plane-wide: metrics-ingest taps via the registry, platform-health
        taps (queue depth / utilization / watts) at every platform's
        drain tail and the liveness heartbeat.  Callers register SLO
        thresholds via ``engine.set_slo`` so rollup buckets count
        error-budget burn."""
        self.telemetry = engine
        self.metrics.telemetry = engine
        for p in self.platforms.values():
            p.telemetry = engine
        return engine

    def attach_qos(self, spec):
        """Attach the QoS layer (repro_torch.core.qos) plane-wide: one
        ``AdmissionController`` gating the unified ``admit`` core
        (per-class token buckets, overload shed/degrade/spillover,
        brownout under an energy cap) and per-class DRR queues at every
        platform — current and elastically joined later.  ``spec`` is a
        ``QosSpec`` or its dict form.  Returns the controller."""
        from repro_torch.core.qos import AdmissionController, QosSpec
        if isinstance(spec, dict):
            spec = QosSpec.from_dict(spec)
        self.qos = spec
        self.admission = AdmissionController(spec, self.clock)
        for p in self.platforms.values():
            p.set_qos(spec)
        return self.admission

    # ----------------------------------------------------------- chains ---
    def chain_executor(self, fns: Dict[str, FunctionSpec], **kw):
        """Factory for a chain executor bound to this control plane (the
        collaborative-execution layer, repro_torch.chains): stage batches
        flow through ``submit_batch``, intermediates land in this plane's
        object stores, transfer accounting in this plane's metrics."""
        from repro_torch.chains.executor import ChainExecutor
        return ChainExecutor(self, fns, **kw)

    # --------------------------------------------------------------- run --
    def run_until(self, t: float):
        self.clock.run_until(t)
        for name, p in self.platforms.items():
            if not p.failed:
                self.detector.heartbeat(name)
            p.energy.update(name, self.clock.now(), p.cpu_util())
