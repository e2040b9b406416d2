"""Chain executor: collaborative execution of planned chains on the FDN.

Built on ``FDNControlPlane.submit_batch``: stage releases are *batched* —
completions mark successors ready, and every stage that became ready in
the same batch window is admitted in one per-platform burst.  Intermediate
objects are recorded into the executing platform's object store, so a
downstream stage placed elsewhere physically pays the inter-platform
transfer through ``DataPlacementManager.access_time`` (the same machinery
single invocations use).  Bytes-moved and transfer-seconds are accounted
into the ``MetricsRegistry`` per chain label.

Optional proactive staging (§3.1.3 (2)): when a stage is admitted, the
*external* inputs of its successors are staged (``stage_for``) onto their
planned platforms, overlapping the pull with the predecessor's execution.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

from repro_torch.chains.planner import ChainPlan
from repro_torch.chains.spec import Chain, DataEdge, Stage
from repro_torch.core.control_plane import FDNControlPlane
from repro_torch.core.loadgen import attach_completion_hooks
from repro_torch.core.types import SLO, FunctionSpec, Invocation


class ChainInstance:
    """One in-flight execution of a chain (a chain 'invocation')."""

    __slots__ = ("id", "label", "chain", "plan", "t0", "end_t", "status",
                 "remaining", "outstanding", "stages_done", "bytes_moved",
                 "transfer_s", "stage_ready")

    def __init__(self, iid: int, label: str, chain: Chain, plan: ChainPlan,
                 t0: float):
        self.id = iid
        self.label = label
        self.chain = chain
        self.plan = plan
        self.t0 = t0
        self.end_t: Optional[float] = None
        self.status = "running"               # running | done | failed
        # stage -> unfinished internal predecessors
        self.remaining: Dict[str, int] = {
            s.name: len(chain.preds(s.name)) for s in chain.stages}
        self.outstanding: Dict[str, int] = {}  # stage -> in-flight invs
        self.stages_done = 0
        self.bytes_moved = 0.0
        self.transfer_s = 0.0
        # stage -> ready instant; only filled when a flight recorder is
        # attached (the chain-stage spans' t0)
        self.stage_ready: Dict[str, float] = {}

    @property
    def latency(self) -> Optional[float]:
        return None if self.end_t is None else self.end_t - self.t0


class _StageSlot:
    """One stage-invocation completion slot.  The original invocation and
    any hedged duplicates the control plane spawns for it (batch-aware
    hedging arms one timer per released stage batch) all point at the
    same slot: the FIRST completion consumes it and advances the chain —
    so a winning speculative duplicate finishes the stage, at the
    platform it actually ran on.  ``carriers`` counts in-flight copies;
    the instance only fails when every carrier is exhausted."""

    __slots__ = ("inst", "stage", "consumed", "carriers")

    def __init__(self, inst: ChainInstance, stage: Stage):
        self.inst = inst
        self.stage = stage
        self.consumed = False
        self.carriers = 1


class ChainExecutor:
    """Drives chain instances over one control plane.

    ``sink`` (optional, a ``loadgen.ColumnarResultSink``) gets its
    ``submitted``/``rejected`` counters bumped for every stage invocation,
    keeping ScenarioReport totals consistent with the per-stage completion
    columns the sink already collects from the platforms.

    Stage releases ride ``FDNControlPlane.submit_batch``, so with hedging
    enabled each released stage batch arms one vectorized hedge timer per
    (fn, platform) group; ``HedgePolicy.on_duplicate`` wires the
    duplicates back into the originals' stage slots.
    """

    METRIC_SCOPE = "_chain"

    def __init__(self, cp: FDNControlPlane, fns: Dict[str, FunctionSpec],
                 sink=None, batch_window_s: float = 0.0,
                 proactive_staging: bool = True,
                 cleanup_intermediates: bool = True):
        self.cp = cp
        self.clock = cp.clock
        self.fns = dict(fns)
        self.sink = sink
        self.batch_window_s = batch_window_s
        self.proactive_staging = proactive_staging
        self.cleanup_intermediates = cleanup_intermediates
        attach_completion_hooks(cp)
        self._ids = itertools.count()
        # (instance, stage, platform) triples awaiting one batched release
        self._pending: List[Tuple[ChainInstance, Stage, str]] = []
        self._flush_scheduled = False
        # in-flight stage invocations (originals AND hedged duplicates)
        # -> their completion slot (failure tracking + first-wins)
        self._owner: Dict[int, _StageSlot] = {}
        for p in cp.platforms.values():
            p.on_fail.append(self._on_platform_fail)
        cp.hedge.on_duplicate.append(self._on_hedge_dup)
        self._spec_cache: Dict[Tuple[str, Tuple[str, ...],
                                     Optional[float]], FunctionSpec] = {}
        self.launched = 0
        self.launched_by_label: Dict[str, int] = {}
        self.completed = 0
        self.failed = 0
        self.plans: Dict[str, ChainPlan] = {}         # label -> plan
        # label -> [(t0, end_t, bytes_moved, transfer_s)]
        self.records: Dict[str, List[Tuple[float, float, float,
                                           float]]] = {}

    # ------------------------------------------------------------ keys ---
    @staticmethod
    def instance_key(inst: ChainInstance, edge: DataEdge) -> str:
        return f"chains/{inst.label}/{inst.id}/{edge.key}"

    def _input_keys(self, inst: ChainInstance,
                    stage: Stage) -> Tuple[str, ...]:
        return tuple(e.key if e.external else self.instance_key(inst, e)
                     for e in inst.chain.in_edges(stage.name))

    # ---------------------------------------------------------- launch ---
    def launch(self, chain: Chain, plan: ChainPlan,
               label: Optional[str] = None) -> ChainInstance:
        """Start one chain instance at the current sim time; its source
        stages join the next batched release."""
        label = label or chain.name
        inst = ChainInstance(next(self._ids), label, chain, plan,
                             self.clock.now())
        self.launched += 1
        self.launched_by_label[label] = \
            self.launched_by_label.get(label, 0) + 1
        self.plans.setdefault(label, plan)
        self.records.setdefault(label, [])
        for s in chain.stages:
            if inst.remaining[s.name] == 0:
                self._enqueue_stage(inst, s)
        return inst

    def _enqueue_stage(self, inst: ChainInstance, stage: Stage):
        pname = inst.plan.assignment[stage.name]
        inst.outstanding[stage.name] = stage.fan_out
        if self.cp.recorder is not None:
            inst.stage_ready[stage.name] = self.clock.now()
        if self.proactive_staging:
            # overlap successors' external pulls with this stage's run;
            # the replication is still a real transfer, so its bytes and
            # seconds are charged to this instance (later instances find
            # the replica already local and pay nothing)
            placement = self.cp.placement
            for succ in inst.chain.succs(stage.name):
                to = inst.plan.assignment[succ]
                staged = []
                for e in inst.chain.in_edges(succ):
                    if not e.external:
                        continue
                    src = placement.locate(e.key, origin=to)
                    if src is not None and src != to:
                        inst.bytes_moved += e.size_bytes
                        inst.transfer_s += placement.transfer_seconds(
                            e.size_bytes, src, to)
                    staged.append(e.key)
                if staged:
                    placement.stage_for(
                        inst.chain.stage(succ).function, staged, to)
        self._pending.append((inst, stage, pname))
        if not self._flush_scheduled:
            self._flush_scheduled = True
            self.clock.after(self.batch_window_s, self._flush)

    def _stage_fn(self, inst: ChainInstance, stage: Stage) -> FunctionSpec:
        """Per-stage spec: the deployed function with this instance's data
        objects (and the stage SLO, when set) attached.  Only stages whose
        inputs are all external are cached — their keys are instance-
        independent; internal edges carry per-instance keys and a cache
        over those would grow with every launch."""
        keys = self._input_keys(inst, stage)
        cacheable = all(e.external
                        for e in inst.chain.in_edges(stage.name))
        cache_key = (stage.function, keys, stage.slo_p90_s)
        if cacheable:
            spec = self._spec_cache.get(cache_key)
            if spec is not None:
                return spec
        spec = self.fns[stage.function]
        kw = {}
        if keys != spec.data_objects:
            kw["data_objects"] = keys
        if stage.slo_p90_s is not None:
            kw["slo"] = SLO(p90_response_s=stage.slo_p90_s)
        if kw:
            spec = spec.replace(**kw)
        if cacheable:
            self._spec_cache[cache_key] = spec
        return spec

    # ----------------------------------------------------------- flush ---
    def _flush(self):
        """One batched release: every stage that became ready inside the
        batch window is admitted through ``submit_batch``, grouped per
        planned platform."""
        self._flush_scheduled = False
        work, self._pending = self._pending, []
        groups: Dict[str, List[Invocation]] = {}
        now = self.clock.now()
        for inst, stage, pname in work:
            if inst.status != "running":     # failed earlier in this flush
                continue
            spec = self._stage_fn(inst, stage)
            self._account_transfers(inst, stage, pname)
            for _ in range(stage.fan_out):
                inv = Invocation(spec, now)
                self._attach_slot(_StageSlot(inst, stage), inv)
                groups.setdefault(pname, []).append(inv)
        for pname, invs in groups.items():
            # an earlier group's rejection may have failed an instance
            # this group also carries work for — drop those invocations
            live = []
            for inv in invs:
                slot = self._owner.get(inv.id)
                if slot is None or slot.inst.status != "running":
                    inv._on_done = None
                    self._owner.pop(inv.id, None)
                else:
                    live.append(inv)
            if not live:
                continue
            if self.sink is not None:
                self.sink.submitted += len(live)
            accepted = self.cp.submit_batch(live, platform_override=pname)
            if accepted == len(live):
                continue
            if self.sink is not None:
                self.sink.rejected += len(live) - accepted
            # a rejected admission never fires _on_done; fail the whole
            # instance so reports do not wait on it forever
            for inv in live:
                if inv.status == "failed":
                    inv._on_done = None
                    slot = self._owner.pop(inv.id, None)
                    self._fail_instance(slot.inst if slot else None)

    def _fail_instance(self, inst: Optional[ChainInstance]):
        if inst is not None and inst.status == "running":
            inst.status = "failed"
            self.failed += 1
            self._cleanup(inst)

    def _on_platform_fail(self, inv: Invocation):
        """Platform-level failure of a stage invocation.  Runs after the
        control plane's redelivery hook (callback registration order): a
        resubmitted invocation is back to 'pending' and may still
        complete, but one the Redeliverer exhausted stays 'failed'.  The
        instance only fails once the slot's LAST carrier (original or
        hedged duplicate) is exhausted and nothing completed it."""
        slot = self._owner.get(inv.id)
        if slot is None:
            return
        if inv.status == "failed":
            self._owner.pop(inv.id, None)
            if slot.consumed:
                return
            slot.carriers -= 1
            if slot.carriers <= 0:
                self._fail_instance(slot.inst)

    def _on_hedge_dup(self, orig: Invocation, dup: Invocation):
        """A speculative duplicate was spawned for one of our stage
        invocations: point it at the same completion slot, first-wins."""
        slot = self._owner.get(orig.id)
        if slot is None or slot.consumed:
            return
        slot.carriers += 1
        self._attach_slot(slot, dup)

    def _account_transfers(self, inst: ChainInstance, stage: Stage,
                           pname: str):
        """Estimate the bytes and seconds this stage pulls across platform
        boundaries (each of the ``fan_out`` invocations reads the inputs)."""
        placement = self.cp.placement
        for e in inst.chain.in_edges(stage.name):
            key = e.key if e.external else self.instance_key(inst, e)
            src = placement.locate(key, origin=pname)
            if src is None or src == pname:
                continue
            moved = e.size_bytes * stage.fan_out
            secs = placement.transfer_seconds(e.size_bytes, src, pname) * \
                stage.fan_out
            inst.bytes_moved += moved
            inst.transfer_s += secs

    # ------------------------------------------------------ completion ---
    def _attach_slot(self, slot: _StageSlot, inv: Invocation):
        self._owner[inv.id] = slot
        inv._on_done = lambda: self._slot_done(slot, inv)

    def _slot_done(self, slot: _StageSlot, completing: Invocation):
        """First completion (original or hedged duplicate) consumes the
        slot and advances the chain; later ones are no-ops."""
        completing._on_done = None
        self._owner.pop(completing.id, None)
        if slot.consumed:
            return
        slot.consumed = True
        self._stage_inv_done(slot.inst, slot.stage, completing)

    def _stage_inv_done(self, inst: ChainInstance, stage: Stage,
                        inv: Invocation):
        inst.outstanding[stage.name] -= 1
        if inst.outstanding[stage.name] > 0 or inst.status != "running":
            return
        # stage complete: record outputs where the stage actually ran
        loc = inv.platform or inst.plan.assignment[stage.name]
        stores = self.cp.placement.stores
        if loc in stores:
            for e in inst.chain.out_edges(stage.name):
                stores[loc].put(self.instance_key(inst, e), e.size_bytes)
        inst.stages_done += 1
        rec = self.cp.recorder
        if rec is not None:
            rec.record_chain_stage(
                inst.id, inv.id, stage.function, inv.platform,
                inst.stage_ready.get(stage.name, inst.t0),
                self.clock.now())
        for succ in inst.chain.succs(stage.name):
            inst.remaining[succ] -= 1
            if inst.remaining[succ] == 0:
                self._enqueue_stage(inst, inst.chain.stage(succ))
        if inst.stages_done == inst.chain.n_stages:
            self._instance_done(inst)

    def _instance_done(self, inst: ChainInstance):
        inst.end_t = self.clock.now()
        inst.status = "done"
        self.completed += 1
        self.records[inst.label].append(
            (inst.t0, inst.end_t, inst.bytes_moved, inst.transfer_s))
        m = self.cp.metrics
        m.add(self.METRIC_SCOPE, inst.label, "chain_latency", inst.end_t,
              inst.end_t - inst.t0)
        m.add(self.METRIC_SCOPE, inst.label, "bytes_moved", inst.end_t,
              inst.bytes_moved)
        m.add(self.METRIC_SCOPE, inst.label, "transfer_s", inst.end_t,
              inst.transfer_s)
        self._cleanup(inst)

    def _cleanup(self, inst: ChainInstance):
        """Drop the instance's intermediate objects (done OR failed runs —
        a failed chain's partial outputs must not leak into the stores)."""
        if not self.cleanup_intermediates:
            return
        for e in inst.chain.edges:
            if not e.external:
                key = self.instance_key(inst, e)
                for st in self.cp.placement.stores.values():
                    st.remove(key)
