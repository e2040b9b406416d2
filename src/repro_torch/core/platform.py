"""TargetPlatform: one homogeneous cluster + its FaaS platform (paper §3).

Reproduces the FaaS semantics the paper measures against:
  * replicas with cold / prewarm / warm lifecycle (OpenWhisk §6.1),
  * reactive autoscaling + faas-idler scale-to-zero (OpenFaaS §2.2.2),
  * GCF elastic unbounded instances w/ per-instance concurrency 1 (§2.2.3),
  * CPU / memory interference from background load (§5.1.2, Figs. 8-9),
  * queueing when capacity is exhausted,
  * per-platform energy accounting (§5.2).

Execution latency comes from an ExecutionModel that can either (a) use the
analytic cost (flops / replica_flops + data-access time from the placement
manager) or (b) really execute the function's torch callable once on its
device (the callable returns only when its device work is done, so the
clock times the work, not its launch), cache the measurement, and scale it
by the platform/host speed ratio.
Everything advances on the deterministic SimClock.

The queue drain is *columnar*: replicas are still assigned FIFO (warmest
free replica first, identical head-of-line semantics to the historical
one-invocation-at-a-time loop), but the per-start math — startup latency,
interference crossovers as busy replicas spill onto background-loaded
cores, the swap cliff as created replicas push memory demand past
physical, execution seconds — is evaluated once per drained burst as
NumPy array ops, with per-function costs (data-access seconds, analytic
execution estimate) hoisted out of the per-invocation path.  A drained
burst therefore makes one vectorized placement pass instead of N scalar
``_start`` calls, while producing bit-identical invocation timings.
"""
from __future__ import annotations

import time as wall_time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import qos as qos_mod
from repro_torch.core.data_placement import DataPlacementManager
from repro_torch.core.energy import EnergyMeter
from repro_torch.core.monitoring import MetricsRegistry
from repro_torch.core.simulator import SimClock
from repro_torch.core.types import FunctionSpec, Invocation, PlatformProfile

COLD, PREWARM, WARM = "cold", "prewarm", "warm"


class _ColumnarEntry:
    """Queue entry for one columnar admission group: row indices into an
    ``InvocationBatch``, consumed head-first by the drain.  ``Invocation``
    objects materialize one by one exactly when a replica starts them;
    ``t`` is the group's enqueue time (the members' ``scheduled_t``)."""

    __slots__ = ("batch", "idxs", "pos", "t")

    def __init__(self, batch, idxs, t: float):
        self.batch = batch
        self.idxs = idxs
        self.pos = 0
        self.t = t


class Replica:
    __slots__ = ("state", "busy", "last_used", "fn", "retired")

    def __init__(self, fn: str, state: str = COLD):
        self.fn = fn
        self.state = state
        self.busy = False
        self.last_used = 0.0
        # set when the idler / destroy / recover removes the replica; lets
        # the free-list skip stale entries lazily instead of rebuilding
        self.retired = False


class ExecutionModel:
    """Latency model with optional real-measurement calibration."""

    def __init__(self, host_flops: float = 2e9):
        self.host_flops = host_flops
        self._measured: Dict[str, float] = {}

    def measure_real(self, fn: FunctionSpec, payloads) -> Optional[float]:
        if fn.real_fn is None:
            return None
        if fn.name not in self._measured:
            # a body that fails raises: no analytic estimate stands in for
            # a broken device path
            fn.real_fn(*payloads)                  # warmup/compile
            t0 = wall_time.perf_counter()
            fn.real_fn(*payloads)
            self._measured[fn.name] = wall_time.perf_counter() - t0
        return self._measured[fn.name]

    def exec_seconds(self, fn: FunctionSpec, prof: PlatformProfile,
                     payloads=()) -> float:
        real = self.measure_real(fn, payloads)
        if real is not None:
            # scale host measurement by platform-vs-host speed ratio
            return real * (self.host_flops / max(prof.replica_flops, 1.0))
        return fn.flops / max(prof.replica_flops, 1.0)


class TargetPlatform:
    def __init__(self, prof: PlatformProfile, clock: SimClock,
                 metrics: MetricsRegistry, energy: EnergyMeter,
                 placement: Optional[DataPlacementManager] = None,
                 exec_model: Optional[ExecutionModel] = None,
                 seed: int = 0):
        self.prof = prof
        self.clock = clock
        self.metrics = metrics
        self.energy = energy
        self.placement = placement
        self.exec_model = exec_model or ExecutionModel()
        self.replicas: Dict[str, List[Replica]] = defaultdict(list)
        # O(1) admission accounting: busy-replica counter + per-function
        # free-replica pools keyed by lifecycle state + a running replica-
        # memory total.  The old full scans of every replica per admission
        # went quadratic under sustained batch load (elastic platforms
        # grow replicas without bound).
        self._busy = 0
        self._free: Dict[str, Dict[str, List[Replica]]] = {}
        self._mem_replicas_mb = 0.0
        # warm-pool accounting (the autoscale layer): exact per-function idle
        # replica counts by lifecycle state (free pools keep lazily-
        # skipped stale entries, so they cannot be counted directly), a
        # running idle total for keep-alive energy, and a generation
        # counter so the warm-pool controller can cache its row view
        self._idle_counts: Dict[str, Dict[str, int]] = {}
        self._idle_total = 0
        self.idle_gen = 0
        # set by the warm-pool controller: per-function admission counts
        # it drains every tick (None == autoscaling off, zero hot-path
        # cost), and a flag disabling the platform's own faas-idler so
        # the controller owns the keep-alive decision
        self.autoscale_counts: Optional[Dict[str, int]] = None
        self.managed_keepalive = False
        self.queue: deque = deque()
        self.deployed: Dict[str, FunctionSpec] = {}
        self.failed = False
        self.bg_cpu = 0.0                  # §5.1.2 interference knobs
        self.bg_mem = 0.0
        self.on_complete: List[Callable[[Invocation], None]] = []
        self.on_fail: List[Callable[[Invocation], None]] = []
        # flight recorder (the observability layer); None keeps every tap
        # to one check
        self.recorder = None
        # live telemetry engine (the telemetry layer); same guard
        # discipline.  queued_rows mirrors the queue depth in rows (a
        # _ColumnarEntry is one deque entry but many rows) so health
        # samples never walk the deque.
        self.telemetry = None
        self.queued_rows = 0
        # QoS layer (repro_torch.core.qos): per-class DRR queues, built by
        # set_qos only for non-uniform weights — _cqueues is None keeps
        # every enqueue/drain on the single-FIFO fast path (exact FIFO
        # recovery AND zero qos-off cost)
        self.qos: Optional[qos_mod.QosSpec] = None
        self._cqueues: Optional[List[deque]] = None
        self._crows: Optional[np.ndarray] = None
        self._deficit: Optional[np.ndarray] = None
        self._weights: Optional[np.ndarray] = None
        self.inflight: Dict[int, Invocation] = {}
        energy.register(prof, clock.now())
        self._idler_scheduled = False

    # ------------------------------------------------------------ deploy --
    def deploy(self, fn: FunctionSpec):
        """Function Deployer: registers fn; ARM platforms need ARM images."""
        if self.prof.arm and fn.runtime == "docker-x86":
            raise ValueError(f"{fn.name}: x86 image cannot run on ARM "
                             f"platform {self.prof.name}")
        old = self.deployed.get(fn.name)
        if old is not None and old.memory_mb != fn.memory_mb:
            # re-deploy with a new footprint: existing replicas are
            # accounted at the *current* deployed spec's size
            self._mem_replicas_mb += len(self.replicas[fn.name]) * \
                (fn.memory_mb - old.memory_mb)
        self.deployed[fn.name] = fn
        for _ in range(self.prof.prewarm_pool):
            rep = Replica(fn.name, PREWARM)
            self.replicas[fn.name].append(rep)
            self._mem_replicas_mb += fn.memory_mb
            self._push_free(rep)

    def destroy(self, fn_name: str):
        spec = self.deployed.pop(fn_name, None)
        reps = self.replicas.pop(fn_name, [])
        if spec is not None:
            self._mem_replicas_mb -= len(reps) * spec.memory_mb
        for r in reps:
            if not r.retired:
                if r.busy:
                    self._busy -= 1
                else:
                    self._idle_sub(fn_name, r.state)
            r.retired = True
        self._free.pop(fn_name, None)
        self._idle_counts.pop(fn_name, None)

    # -------------------------------------------------------------- qos ---
    def set_qos(self, spec: Optional["qos_mod.QosSpec"]):
        """Attach per-class deficit-round-robin queueing.  Uniform
        weights (or None) keep the single FIFO deque — DRR with equal
        quanta *is* FIFO, so the recovery is structural and the qos-off
        drain stays byte-identical."""
        self.qos = spec
        if spec is not None and spec.drr_enabled():
            if self._cqueues is None:
                self._cqueues = [deque() for _ in range(qos_mod.N_QOS)]
                self._crows = np.zeros(qos_mod.N_QOS, np.int64)
                self._deficit = np.zeros(qos_mod.N_QOS, np.int64)
            self._weights = np.asarray(spec.weights, np.int64)
        else:
            self._cqueues = None
            self._crows = None
            self._deficit = None
            self._weights = None

    # ------------------------------------------------------- accounting ---
    def busy_replicas(self) -> int:
        return self._busy

    def _idle_pools(self, fn: str) -> Dict[str, int]:
        counts = self._idle_counts.get(fn)
        if counts is None:
            counts = {WARM: 0, PREWARM: 0, COLD: 0}
            self._idle_counts[fn] = counts
        return counts

    def _idle_add(self, fn: str, state: str):
        self._idle_pools(fn)[state] += 1
        self._idle_total += 1
        self.idle_gen += 1

    def _idle_sub(self, fn: str, state: str):
        self._idle_pools(fn)[state] -= 1
        self._idle_total -= 1
        self.idle_gen += 1

    def idle_warm(self, fn: str) -> int:
        """Free replicas of ``fn`` that would serve without a cold start
        (WARM + PREWARM) — O(1), exact (stale free-pool entries excluded)."""
        counts = self._idle_counts.get(fn)
        if counts is None:
            return 0
        return counts[WARM] + counts[PREWARM]

    def idle_warm_total(self) -> int:
        """All idle replicas across functions (keep-alive watt accounting)."""
        return self._idle_total

    def _push_free(self, rep: Replica):
        pools = self._free.get(rep.fn)
        if pools is None:
            pools = {WARM: [], PREWARM: [], COLD: []}
            self._free[rep.fn] = pools
        pools[rep.state].append(rep)
        self._idle_add(rep.fn, rep.state)

    def replica_count(self, fn: str) -> int:
        return len(self.replicas[fn])

    def cpu_util(self) -> float:
        cap = max(self.prof.total_replicas, 1)
        return min(1.0, self.bg_cpu + self.busy_replicas() / cap)

    def mem_used_mb(self) -> float:
        return self._mem_replicas_mb + \
            self.bg_mem * self.prof.total_memory_mb

    def mem_util(self) -> float:
        return min(1.5, self.mem_used_mb() / max(self.prof.total_memory_mb,
                                                 1))

    def _touch_energy(self):
        self.energy.update(self.prof.name, self.clock.now(), self.cpu_util(),
                           idle_warm=self._idle_total)

    def _sample_infra(self):
        if not self.prof.infra_metrics_visible:
            return
        t = self.clock.now()
        self.metrics.add(self.prof.name, "_infra", "cpu_util", t,
                         self.cpu_util())
        self.metrics.add(self.prof.name, "_infra", "mem_util", t,
                         self.mem_util())

    # ------------------------------------------------------- scheduling ---
    def can_start_replica(self, fn: FunctionSpec) -> bool:
        if self.prof.elastic:
            return True
        # Background CPU load does NOT reserve replica slots (the OS time-
        # shares; slowdown is modeled in _interference_factor — Fig. 8).
        if self.busy_replicas() >= self.prof.total_replicas:
            return False
        free_mb = self.prof.total_memory_mb - self.mem_used_mb()
        if free_mb >= fn.memory_mb:
            return True
        # CPU platforms can overcommit into swap (Fig. 9's cliff applies);
        # TPU pods (chips > 0) cannot — HBM does not swap.
        return self.prof.chips == 0 and \
            fn.memory_mb <= self.prof.total_memory_mb

    def invoke(self, inv: Invocation):
        """Entry point from the sidecar/control plane."""
        if not self._enqueue(inv):
            return
        self._drain()
        self._schedule_idler()

    def invoke_batch(self, invs):
        """Batched entry point: enqueue the whole group, then drain once.

        FIFO semantics are identical to repeated ``invoke`` calls (the
        drain assigns replicas in queue order either way); the saving is
        one vectorized queue drain + one energy/infra sample per batch
        instead of per invocation (with the per-invocation ``_enqueue``
        body inlined over hoisted locals — it is the one loop every
        admitted invocation must pass through)."""
        if self.failed:
            for inv in invs:
                self._fail(inv, "platform down")
            return
        deployed = self.deployed
        inflight = self.inflight
        queue_append = self.queue.append
        cq = self._cqueues
        crows = self._crows
        pname = self.prof.name
        now = self.clock.now()
        counts = self.autoscale_counts
        queued = False
        for inv in invs:
            name = inv.fn.name
            if name not in deployed:
                self._fail(inv, "function not deployed")
                continue
            inv.platform = pname
            inv.scheduled_t = now
            inv.status = "queued"
            inflight[inv.id] = inv
            if cq is None:
                queue_append(inv)
            else:
                cq[inv.qos].append(inv)
                crows[inv.qos] += 1
            self.queued_rows += 1
            if counts is not None:
                counts[name] = counts.get(name, 0) + 1
            queued = True
        if queued:
            self._drain()
            self._schedule_idler()

    def invoke_columns(self, batch, idxs: np.ndarray):
        """Array-native entry point: enqueue a whole admission group as
        ONE ``_ColumnarEntry`` and drain once.

        FIFO semantics are identical to ``invoke_batch`` over the
        materialized rows — the drain consumes the entry head-first in
        index order — but no ``Invocation`` object exists until a replica
        actually starts a row (undeployed/failed rows materialize just to
        travel the failure path, like the object path fails them before
        queueing the rest)."""
        if idxs.size == 0:
            return
        batch_fidx = batch.fn_idx
        specs = batch.specs
        if self.failed:
            for i in idxs:
                self._fail(batch.materialize(int(i)), "platform down")
            return
        deployed = self.deployed
        dep_ok = np.array([s.name in deployed for s in specs])
        if not dep_ok.all():
            member_ok = dep_ok[batch_fidx[idxs]]
            if not member_ok.all():
                for i in idxs[~member_ok]:
                    self._fail(batch.materialize(int(i)),
                               "function not deployed")
                idxs = idxs[member_ok]
                if idxs.size == 0:
                    return
        counts = self.autoscale_counts
        if counts is not None:
            c = np.bincount(batch_fidx[idxs], minlength=len(specs))
            for j, k in enumerate(c):
                if k:
                    name = specs[j].name
                    counts[name] = counts.get(name, 0) + int(k)
        cq = self._cqueues
        if cq is None:
            self.queue.append(_ColumnarEntry(batch, idxs, self.clock.now()))
        else:
            # split the group by class: one entry per class present, FIFO
            # within class preserved (idxs are in admission order)
            now = self.clock.now()
            qcol = batch.qos[idxs]
            crows = self._crows
            for c in range(qos_mod.N_QOS):
                sel = idxs[qcol == np.int8(c)]
                if sel.size:
                    cq[c].append(_ColumnarEntry(batch, sel, now))
                    crows[c] += int(sel.size)
        self.queued_rows += int(idxs.size)
        self._drain()
        self._schedule_idler()

    def _enqueue(self, inv: Invocation) -> bool:
        if self.failed:
            self._fail(inv, "platform down")
            return False
        if inv.fn.name not in self.deployed:
            self._fail(inv, "function not deployed")
            return False
        inv.platform = self.prof.name
        inv.scheduled_t = self.clock.now()
        inv.status = "queued"
        self.inflight[inv.id] = inv
        if self._cqueues is None:
            self.queue.append(inv)
        else:
            self._cqueues[inv.qos].append(inv)
            self._crows[inv.qos] += 1
        self.queued_rows += 1
        counts = self.autoscale_counts
        if counts is not None:
            name = inv.fn.name
            counts[name] = counts.get(name, 0) + 1
        return True

    def _find_replica(self, fn: str) -> Optional[Replica]:
        """Warmest free replica (WARM > PREWARM > COLD), popped from the
        per-state free pools in O(1); stale entries (retired by the idler,
        or whose state moved on) are skipped lazily."""
        pools = self._free.get(fn)
        if pools is None:
            return None
        for state in (WARM, PREWARM, COLD):
            lst = pools[state]
            while lst:
                r = lst.pop()
                if r.retired or r.busy or r.state != state:
                    continue
                self._idle_sub(fn, state)
                return r
        return None

    def _fn_start_cost(self, fn: FunctionSpec) -> Tuple[float, float]:
        """(analytic/measured exec seconds, data-access seconds) for one
        invocation of ``fn`` right now — constant within one drain, so it
        is computed once per distinct function and broadcast."""
        data_t = 0.0
        payloads = []
        if self.placement is not None:
            for obj in fn.data_objects:
                data_t += self.placement.access_time(obj, self.prof.name)
                payloads.append(self.placement.payload(obj))
        return self.exec_model.exec_seconds(fn, self.prof, payloads), data_t

    def _drain(self):
        """Assign free/new replicas to the queue head (FIFO; stops at the
        first invocation that cannot start), then launch every assigned
        invocation in one vectorized pass."""
        if self._cqueues is not None:
            return self._drain_qos()
        queue = self.queue
        if queue and not self.failed:
            now = self.clock.now()
            prof = self.prof
            base_busy = self._busy
            starts: List[Tuple[Invocation, FunctionSpec, Replica]] = []
            startups: List[float] = []
            colds: List[bool] = []
            mem_at: List[float] = []
            exec_base: List[float] = []
            data_ts: List[float] = []
            # per-fn hoisting is only sound while access costs are pure;
            # with the LRU data cache enabled every access mutates cache
            # state, so costs are evaluated per invocation in FIFO order
            hoist = self.placement is None or not self.placement.cache_enabled
            fn_cache: Dict[int, list] = {}   # id(fn) -> [exec, data, fn, n]
            pname = prof.name
            while queue:
                head = queue[0]
                entry = head if type(head) is _ColumnarEntry else None
                if entry is not None:
                    b = entry.batch
                    i = int(entry.idxs[entry.pos])
                    fn = b.specs[b.fn_idx[i]]
                else:
                    fn = head.fn
                rep = self._find_replica(fn.name)
                if rep is None:
                    if not self.can_start_replica(fn):
                        break
                    rep = Replica(fn.name, COLD)
                    self.replicas[fn.name].append(rep)
                    spec = self.deployed.get(fn.name)
                    if spec is not None:
                        self._mem_replicas_mb += spec.memory_mb
                if entry is None:
                    inv = head
                    queue.popleft()
                else:
                    # lazy materialization: the Invocation object is born
                    # at replica-assignment time, with the bookkeeping the
                    # object path applied at enqueue
                    inv = b.materialize(i)
                    inv.platform = pname
                    inv.scheduled_t = entry.t
                    inv.status = "queued"
                    self.inflight[inv.id] = inv
                    entry.pos += 1
                    if entry.pos == entry.idxs.size:
                        queue.popleft()
                state = rep.state
                if state == COLD:
                    startups.append(prof.cold_start_s)
                    colds.append(True)
                elif state == PREWARM:
                    # a prewarmed container pays only its attach cost and
                    # does NOT count as a cold start — avoiding the cold
                    # flag is exactly what prewarming buys (§6.1)
                    startups.append(prof.cold_start_s * 0.15)
                    colds.append(False)
                else:
                    startups.append(0.0)
                    colds.append(False)
                rep.state = WARM
                rep.busy = True
                rep.last_used = now
                self._busy += 1
                mem_at.append(self._mem_replicas_mb)
                if hoist:
                    cached = fn_cache.get(id(fn))
                    if cached is None:
                        e, d = self._fn_start_cost(fn)
                        cached = [e, d, fn, 0]
                        fn_cache[id(fn)] = cached
                    cached[3] += 1
                    e, d = cached[0], cached[1]
                else:
                    e, d = self._fn_start_cost(fn)
                    if self.placement is not None:
                        for obj in fn.data_objects:
                            self.placement.record_access(fn.name, obj)
                exec_base.append(e)
                data_ts.append(d)
                starts.append((inv, fn, rep))
            if starts:
                if hoist and self.placement is not None:
                    for _e, _d, fn, count in fn_cache.values():
                        for obj in fn.data_objects:
                            self.placement.record_access(fn.name, obj,
                                                         count=count)
                self._launch(starts, startups, colds, mem_at, exec_base,
                             data_ts, base_busy, now)
                self.queued_rows -= len(starts)
        self._touch_energy()
        self._sample_infra()
        tel = self.telemetry
        if tel is not None:
            self.sample_health(tel)

    def _drain_qos(self):
        """DRR twin of ``_drain``: the per-start body is identical (same
        replica assignment, same hoisting, same ``_launch``), but the
        serve *order* follows a vectorized deficit-round-robin plan over
        the per-class queues — one ``np.lexsort`` per drain
        (``qos.drr_plan``), deficits committed back afterwards
        (``qos.drr_commit``).  Head-of-line blocking is global: the
        first planned row that cannot start stops the drain, exactly
        like the FIFO drain stops at its queue head."""
        cq = self._cqueues
        crows = self._crows
        total_backlog = int(crows.sum())
        if total_backlog and not self.failed:
            now = self.clock.now()
            prof = self.prof
            # upper bound on possible starts this drain: every start
            # either consumes a free replica or creates one (creation
            # stops at total_replicas busy) — keeps the plan size
            # proportional to serveable rows, not to the backlog
            if prof.elastic:
                cap = total_backlog
            else:
                cap = min(total_backlog, self._idle_total +
                          max(0, prof.total_replicas - self._busy))
            if cap > 0:
                plan_cls, plan_rounds = qos_mod.drr_plan(
                    crows, self._deficit, self._weights, cap)
                base_busy = self._busy
                starts: List[Tuple[Invocation, FunctionSpec, Replica]] = []
                startups: List[float] = []
                colds: List[bool] = []
                mem_at: List[float] = []
                exec_base: List[float] = []
                data_ts: List[float] = []
                hoist = self.placement is None or \
                    not self.placement.cache_enabled
                fn_cache: Dict[int, list] = {}
                pname = prof.name
                served = [0] * qos_mod.N_QOS
                plan_len = int(plan_cls.size)
                p = 0
                while p < plan_len:
                    c = int(plan_cls[p])
                    queue = cq[c]
                    head = queue[0]
                    entry = head if type(head) is _ColumnarEntry else None
                    if entry is not None:
                        b = entry.batch
                        i = int(entry.idxs[entry.pos])
                        fn = b.specs[b.fn_idx[i]]
                    else:
                        fn = head.fn
                    rep = self._find_replica(fn.name)
                    if rep is None:
                        if not self.can_start_replica(fn):
                            break
                        rep = Replica(fn.name, COLD)
                        self.replicas[fn.name].append(rep)
                        spec = self.deployed.get(fn.name)
                        if spec is not None:
                            self._mem_replicas_mb += spec.memory_mb
                    if entry is None:
                        inv = head
                        queue.popleft()
                    else:
                        inv = b.materialize(i)
                        inv.platform = pname
                        inv.scheduled_t = entry.t
                        inv.status = "queued"
                        self.inflight[inv.id] = inv
                        entry.pos += 1
                        if entry.pos == entry.idxs.size:
                            queue.popleft()
                    state = rep.state
                    if state == COLD:
                        startups.append(prof.cold_start_s)
                        colds.append(True)
                    elif state == PREWARM:
                        startups.append(prof.cold_start_s * 0.15)
                        colds.append(False)
                    else:
                        startups.append(0.0)
                        colds.append(False)
                    rep.state = WARM
                    rep.busy = True
                    rep.last_used = now
                    self._busy += 1
                    mem_at.append(self._mem_replicas_mb)
                    if hoist:
                        cached = fn_cache.get(id(fn))
                        if cached is None:
                            e, d = self._fn_start_cost(fn)
                            cached = [e, d, fn, 0]
                            fn_cache[id(fn)] = cached
                        cached[3] += 1
                        e, d = cached[0], cached[1]
                    else:
                        e, d = self._fn_start_cost(fn)
                        if self.placement is not None:
                            for obj in fn.data_objects:
                                self.placement.record_access(fn.name, obj)
                    exec_base.append(e)
                    data_ts.append(d)
                    starts.append((inv, fn, rep))
                    served[c] += 1
                    p += 1
                self._deficit = qos_mod.drr_commit(
                    self._deficit, self._weights, crows, served,
                    plan_cls, plan_rounds, p)
                crows -= np.asarray(served, np.int64)
                if starts:
                    if hoist and self.placement is not None:
                        for _e, _d, fn, count in fn_cache.values():
                            for obj in fn.data_objects:
                                self.placement.record_access(fn.name, obj,
                                                             count=count)
                    self._launch(starts, startups, colds, mem_at,
                                 exec_base, data_ts, base_busy, now)
                    self.queued_rows -= len(starts)
        self._touch_energy()
        self._sample_infra()
        tel = self.telemetry
        if tel is not None:
            self.sample_health(tel)

    # -------------------------------------------------------- execution ---
    def _interference_factor(self) -> float:
        """Instantaneous CPU + memory interference — the scalar form of
        the per-burst vectors in ``_launch`` (see its docstring).  The
        two MUST stay formula-identical: the n == 1 drain fast path uses
        this, larger bursts the vectorized copy."""
        total = max(self.prof.total_replicas, 1)
        free_cores = (1.0 - self.bg_cpu) * total
        factor = 1.0 if self.busy_replicas() <= free_cores + 1e-9 else 2.0
        if self.mem_util() > 1.0 + 1e-6:                # swap cliff
            factor *= 7.0
        return factor

    def _launch(self, starts, startups, colds, mem_at, exec_base, data_ts,
                base_busy: int, now: float):
        """Vectorized ``_start``: one pass of array math for the whole
        drained burst (paper §5.1.2, Figs. 8-9 interference semantics).

        CPU interference: background load occupies bg_cpu * cores fully;
        while function replicas fit on the remaining free cores there is
        no slowdown (paper: +50% load -> no effect).  Once they spill onto
        bg-occupied cores the OS time-shares 1:1 -> ~2x (paper: +100% load
        -> ~2x P90).  The busy count each start observes is the running
        total *including itself* (``base_busy + 1 + i``), exactly like the
        sequential loop this replaces.

        Memory: swap thrash is a cliff — as soon as demand (including
        replicas created earlier in this very drain, tracked by
        ``mem_at``) exceeds physical memory, latency jumps ~7x (paper:
        0.8 s -> 6 s P90).

        Interference slows the whole request path (gateway/watchdog/
        invoker contend for the same cores and memory as the function).
        """
        prof = self.prof
        n = len(starts)
        total = max(prof.total_replicas, 1)
        free_cores = (1.0 - self.bg_cpu) * total
        if n == 1:                     # scalar drain (closed-loop path):
            inv, fn, rep = starts[0]   # same formulas, no array overhead
            # a single start observes exactly the platform's current
            # state (busy == base_busy + 1, memory == mem_at[0])
            factor = self._interference_factor()
            exec_time = (exec_base[0] + prof.overhead_s) * factor \
                + data_ts[0]
            st = now + startups[0]
            inv.status = "running"
            inv.start_t = st
            inv.queue_time = st - inv.arrival_t
            inv.exec_time = exec_time
            inv.data_time = data_ts[0]
            if colds[0]:
                inv.cold_start = True
            self.clock.schedule(now + (startups[0] + exec_time),
                                self._finish_cb(inv, fn, rep))
            rec = self.recorder
            if rec is not None:
                # fire expression repeated verbatim: the recorded EXEC end
                # must equal the scheduled completion instant bit-for-bit
                rec.record_launch((inv,), (fn,), prof.name, now,
                                  (startups[0],), (data_ts[0],),
                                  (now + (startups[0] + exec_time),),
                                  (colds[0],))
            return
        busy_at = base_busy + 1 + np.arange(n)
        factor = np.where(busy_at <= free_cores + 1e-9, 1.0, 2.0)
        pressure = np.minimum(
            1.5, (np.asarray(mem_at) + self.bg_mem * prof.total_memory_mb)
            / max(prof.total_memory_mb, 1))
        factor = np.where(pressure > 1.0 + 1e-6, factor * 7.0, factor)

        startup = np.asarray(startups)
        exec_times = (np.asarray(exec_base) + prof.overhead_s) * factor \
            + np.asarray(data_ts)
        fire_at = now + (startup + exec_times)

        start_l = (now + startup).tolist()
        exec_l = exec_times.tolist()
        cbs: List[Callable[[], None]] = []
        for i, (inv, fn, rep) in enumerate(starts):
            st = start_l[i]
            inv.status = "running"
            inv.start_t = st
            inv.queue_time = st - inv.arrival_t
            inv.exec_time = exec_l[i]
            inv.data_time = data_ts[i]
            if colds[i]:
                inv.cold_start = True
            cbs.append(self._finish_cb(inv, fn, rep))
        self.clock.schedule_many(fire_at.tolist(), cbs)
        rec = self.recorder
        if rec is not None:
            rec.record_launch([s[0] for s in starts],
                              [s[1] for s in starts], prof.name, now,
                              startup, data_ts, fire_at, colds)

    def _finish_cb(self, inv: Invocation, fn: FunctionSpec,
                   rep: Replica) -> Callable[[], None]:
        def finish():
            rep.busy = False
            rep.last_used = self.clock.now()
            if not rep.retired:
                self._busy -= 1
                self._push_free(rep)
            if self.failed or inv.status == "failed":
                return
            inv.end_t = self.clock.now()
            inv.status = "done"
            self.inflight.pop(inv.id, None)
            self.metrics.record_completion(
                inv, visible_infra=self.prof.infra_metrics_visible)
            self.metrics.add(self.prof.name, fn.name, "replicas",
                             inv.end_t, float(self.replica_count(fn.name)))
            for cb in self.on_complete:
                cb(inv)
            self._drain()

        return finish

    def _fail(self, inv: Invocation, reason: str):
        inv.status = "failed"
        inv.end_t = self.clock.now()
        self.inflight.pop(inv.id, None)
        for cb in self.on_fail:
            cb(inv)

    # ------------------------------------------------ faas-idler / warm ---
    def _schedule_idler(self):
        if self._idler_scheduled or self.prof.scale_to_zero_s <= 0 or \
                self.managed_keepalive:
            return
        self._idler_scheduled = True

        def idle_check():
            self._idler_scheduled = False
            if self.managed_keepalive:   # controller attached mid-run
                return
            now = self.clock.now()
            for fn, rs in list(self.replicas.items()):
                spec = self.deployed.get(fn)
                keep = []
                for r in rs:
                    if r.busy or now - r.last_used < \
                            self.prof.scale_to_zero_s or r.state == PREWARM:
                        keep.append(r)
                    else:
                        r.retired = True
                        self._idle_sub(fn, r.state)
                        if spec is not None:
                            self._mem_replicas_mb -= spec.memory_mb
                self.replicas[fn] = keep
            self._touch_energy()
            if any(self.replicas.values()):
                self._schedule_idler()

        self.clock.after(self.prof.scale_to_zero_s, idle_check)

    def prewarm(self, fn_name: str, n: int):
        """Warm-pool grow transition: start ``n`` prewarmed containers
        (predictive prewarming, §3.3 (1) / the autoscale layer)."""
        if n <= 0 or self.failed:
            return
        spec = self.deployed.get(fn_name)
        if spec is None:                 # undeployed (or destroyed mid-run)
            return
        now = self.clock.now()
        for _ in range(n):
            rep = Replica(fn_name, PREWARM)
            rep.last_used = now          # keep-alive TTL runs from creation
            self.replicas[fn_name].append(rep)
            self._mem_replicas_mb += spec.memory_mb
            self._push_free(rep)
        self._touch_energy()

    def retire(self, fn_name: str, n: int) -> int:
        """Warm-pool shrink transition: retire up to ``n`` idle replicas of
        ``fn_name``, coldest-first (COLD, then PREWARM, then WARM), and
        release their memory from the O(1) running total.  Returns the
        number actually retired (busy replicas are never touched)."""
        pools = self._free.get(fn_name)
        retired = 0
        if pools is not None and n > 0:
            spec = self.deployed.get(fn_name)
            for state in (COLD, PREWARM, WARM):
                lst = pools[state]
                while lst and retired < n:
                    r = lst.pop()
                    if r.retired or r.busy or r.state != state:
                        continue
                    r.retired = True
                    self._idle_sub(fn_name, state)
                    if spec is not None:
                        self._mem_replicas_mb -= spec.memory_mb
                    retired += 1
                if retired >= n:
                    break
            if retired:
                live = [r for r in self.replicas[fn_name] if not r.retired]
                self.replicas[fn_name] = live
                self._touch_energy()
        return retired

    def enforce_keepalive(self, fn_name: str, ttl_s: float,
                          keep: int = 0) -> Tuple[int, float]:
        """TTL sweep for one function's warm pool: retire idle replicas
        unused for at least ``ttl_s`` seconds, preserving the ``keep``
        youngest-idle ones (the controller's desired pool floor).

        Returns ``(retired, next_due)`` where ``next_due`` is the earliest
        sim-time any of the *surviving* idle replicas could expire (+inf
        when none are idle) — the controller uses it to skip sweeps that
        cannot retire anything."""
        now = self.clock.now()
        n_idle = self.idle_warm(fn_name)
        if n_idle <= keep:
            # nothing retirable *at this desired level*; if the desired
            # floor drops later, re-check after a TTL (bounded staleness)
            # — a pool that empties bumps idle_gen and re-arms the sweep
            return 0, (now + ttl_s if n_idle else float("inf"))
        spec = self.deployed.get(fn_name)
        idle = [r for r in self.replicas[fn_name]
                if not r.busy and not r.retired]
        idle.sort(key=lambda r: r.last_used)      # oldest-idle first
        surplus = len(idle) - keep
        retired = 0
        for r in idle[:surplus]:
            if now - r.last_used < ttl_s:
                break
            r.retired = True
            self._idle_sub(fn_name, r.state)
            if spec is not None:
                self._mem_replicas_mb -= spec.memory_mb
            retired += 1
        if retired:
            live = [r for r in self.replicas[fn_name] if not r.retired]
            self.replicas[fn_name] = live
            self._touch_energy()
        survivors = idle[retired:]
        next_due = survivors[0].last_used + ttl_s if survivors \
            else float("inf")
        return retired, next_due

    # ------------------------------------------------------------ faults --
    def fail(self):
        """Platform outage: every in-flight invocation is lost.  Queued
        columnar rows that never materialized are materialized now so they
        travel the same failure path (redelivery sees real objects)."""
        self.failed = True
        lost = list(self.inflight.values())
        queues = [self.queue] if self._cqueues is None \
            else [self.queue, *self._cqueues]
        for q in queues:
            for head in q:
                if type(head) is _ColumnarEntry:
                    for i in head.idxs[head.pos:]:
                        inv = head.batch.materialize(int(i))
                        inv.platform = self.prof.name
                        inv.scheduled_t = head.t
                        lost.append(inv)
        self.inflight.clear()
        for q in queues:
            q.clear()
        if self._crows is not None:
            self._crows[:] = 0
        self.queued_rows = 0
        for inv in lost:
            self._fail(inv, "platform failure")
        self._touch_energy()

    def sample_health(self, tel) -> None:
        """Push one (queue depth, utilization, watts) health sample to
        the telemetry engine — called from the drain tail and the
        control plane's liveness heartbeat."""
        util = 0.0 if self.failed else self.cpu_util()
        tel.record_health(self.prof.name, self.clock.now(),
                          float(self.queued_rows), util,
                          self.energy.power_w(self.prof.name, util))

    def recover(self):
        self.failed = False
        self.queued_rows = 0
        if self._crows is not None:
            self._crows[:] = 0
            self._deficit[:] = 0
        for rs in self.replicas.values():
            for r in rs:
                r.retired = True
            rs.clear()
        self._free.clear()
        self._busy = 0
        self._mem_replicas_mb = 0.0
        self._idle_counts.clear()
        self._idle_total = 0
        self.idle_gen += 1
