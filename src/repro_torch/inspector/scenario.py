"""FDNInspector scenarios: "benchmark the FDN" as data (paper §5).

A ``Scenario`` is a declarative spec — platforms, per-function workload
mix (closed-loop VUs and/or open-loop arrival streams), scheduling policy,
SLO overrides, fault schedule, seed, duration — and ``run_scenario``
assembles the control plane, drives everything on one SimClock, and emits
a versioned ``ScenarioReport``: per-platform / per-function p50/p90/p99,
SLO-violation rate, cold starts, energy, decisions per simulated second.

Reports are reproducible artifacts: with ``analytic=True`` (the default;
execution cost from the analytic model, no wall-clock measurement) two
runs of the same scenario produce byte-identical canonical JSON on any
machine.  Completions stream into a ``ColumnarResultSink`` and are bulk-
ingested into the metrics registry at the end of the run
(``MetricsRegistry.record_completions``), so a 10^6-invocation scenario
never touches a per-sample Python hot path.

The function bodies and the seeded store objects live on ``device`` (the
CUDA card unless the caller asks for the CPU); where the scheduler's torch
backend computes is ``scheduler.set_score_device``.  The autoscale and
observability layers are not ported yet: a scenario that turns on
``autoscale``, ``trace``, ``telemetry`` or ``provenance`` raises
``NotImplementedError`` naming its ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import InitVar, dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core import functions as fn_mod
from repro_torch.core import profiles as prof_mod
from repro_torch.core.control_plane import FDNControlPlane
from repro_torch.core.qos import N_QOS, QOS_NAMES, QosSpec, qos_id
from repro_torch.core.gateway import Gateway
from repro_torch.core.loadgen import (ColumnarResultSink,
                                      attach_completion_hooks,
                                      schedule_arrival_mix, spawn_vus)
from repro_torch.core.monitoring import percentile_unsorted
from repro_torch.core.scheduler import (DataLocalityPolicy, EnergyAwarePolicy,
                                        PerformanceRankedPolicy,
                                        RoundRobinCollaboration,
                                        SLOCompositePolicy,
                                        UtilizationAwarePolicy,
                                        WarmAwarePolicy,
                                        WeightedCollaboration)
from repro_torch.core.types import SLO, DeploymentSpec, Invocation
from repro_torch.device import DeviceLike
from repro_torch.chains import catalog as chain_catalog
from repro_torch.chains.executor import ChainExecutor  # noqa: F401
from repro_torch.chains.planner import DataGravityPlanner
from repro_torch.inspector import traces

SCHEMA_VERSION = 1

REMOTE_STORE = "gcp-us-east"
REMOTE_BW = 2e6                 # WAN Germany <-> us-east (Fig. 11)

IMAGE_KEY = "images/sample.jpg"
JSON_KEY = "json/coords.json"


# ---------------------------------------------------------------------------
# Declarative spec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Workload:
    """One load stream of the mix.

    ``mode="open"``: ``arrival`` is a ``traces.build_arrivals`` spec dict
    (seeded per workload: scenario seed + stream index).
    ``mode="closed"``: ``vus`` k6-style virtual users with ``sleep_s``
    think time.
    ``mode="chain"``: ``chain`` names a ``repro_torch.chains.catalog``
    template; each arrival launches one chain instance, planned once per
    workload by the data-gravity planner in ``plan_mode`` and reported under
    ``label`` (default ``"<chain>@<plan_mode>"``).

    ``qos_class`` / ``tenant`` tag every invocation of the stream with a
    QoS class (``latency_critical`` | ``standard`` | ``batch``) and a
    tenant id — the columns the DRR queues drain by and the report's
    fairness sections aggregate over."""
    function: str = ""
    mode: str = "open"                       # "open" | "closed" | "chain"
    arrival: Optional[Dict[str, Any]] = None
    vus: int = 0
    sleep_s: float = 0.0
    jitter: float = 0.05
    chain: Optional[str] = None              # chains.catalog name
    plan_mode: str = "auto"                  # chains.planner.PLAN_MODES
    label: Optional[str] = None              # per_chain report key
    qos_class: str = "standard"              # repro_torch.core.qos class name
    tenant: int = 0

    def __post_init__(self):
        if self.mode == "chain":
            if not self.chain:
                raise ValueError(
                    "chain workload needs chain=<catalog name>")
        elif not self.function:
            raise ValueError(
                f"{self.mode!r} workload needs a function name")
        qos_id(self.qos_class)               # validate early


@dataclass(frozen=True)
class FaultEvent:
    """Scheduled platform outage / recovery (§3.1.3 fault tolerance)."""
    t: float
    platform: str
    action: str                              # "fail" | "recover"


@dataclass(frozen=True)
class TracingSpec:
    """Typed form of the flight-recorder knobs (``trace`` /
    ``trace_sample``).  Passed as ``Scenario(tracing=...)`` it normalizes
    into the flat fields, so the serialized spec — and every golden —
    stays byte-identical with the legacy constructor."""
    enabled: bool = True
    sample: float = 1.0


@dataclass(frozen=True)
class AutoscaleSpec:
    """Typed form of the ``autoscale`` config dict (policy, tick, backend,
    policy kwargs).  ``to_dict`` emits exactly the keys ``assemble``
    consumes, omitting unset ones so the scenario echo matches a
    hand-written dict."""
    policy: str = "predictive"
    tick_s: float = 1.0
    backend: Optional[str] = None
    policy_kwargs: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"policy": self.policy,
                               "tick_s": float(self.tick_s)}
        if self.backend is not None:
            out["backend"] = self.backend
        if self.policy_kwargs is not None:
            out["policy_kwargs"] = dict(self.policy_kwargs)
        return out


@dataclass(frozen=True)
class Scenario:
    name: str
    platforms: Tuple[str, ...]
    workloads: Tuple[Workload, ...]
    duration_s: float
    policy: str = "slo_composite"            # scheduler.POLICIES key
    policy_kwargs: Dict[str, Any] = field(default_factory=dict)
    lb_policy: Optional[str] = None          # collaboration at the gateway
    lb_kwargs: Dict[str, Any] = field(default_factory=dict)
    platform_override: Optional[str] = None  # exclusive per-platform runs
    data_location: str = "cloud-cluster"
    # extra inter-location bandwidth pins, (loc_a, loc_b, bytes/s): the
    # WAN-speed knob the chain split-vs-colocate A/Bs sweep
    bandwidths: Tuple[Tuple[str, str, float], ...] = ()
    seed: int = 42
    analytic: bool = True                    # strip real function bodies
    batch_window_s: float = 0.05
    # admit open-loop arrivals as struct-of-arrays InvocationBatch chunks
    # (lazy Invocation materialization); False replays the object path —
    # decisions and timings are identical either way (tests pin it)
    columnar: bool = True
    drain_s: float = 120.0
    faults: Tuple[FaultEvent, ...] = ()
    slo_overrides: Dict[str, float] = field(default_factory=dict)
    defer_metrics: bool = True               # bulk-ingest completions
    retain_objects: bool = False             # keep per-invocation lists
    enable_hedging: bool = False
    predictive_prewarm: bool = False
    # warm-pool lifecycle (the autoscale layer, not ported yet):
    # {"policy": "ttl" | "scale_to_zero" | "concurrency" | "predictive",
    # "tick_s": ..., "backend": ..., "policy_kwargs": {...}}; None leaves
    # platforms on their own faas-idler
    autoscale: Optional[Dict[str, Any]] = None
    # keep-alive watts charged per idle warm replica (0 keeps the
    # historical accounting; the prewarm-policy studies set it)
    keepalive_w_per_replica: float = 0.0
    # background CPU load per platform (§5.1.2 interference knob)
    bg_cpu: Dict[str, float] = field(default_factory=dict)
    # background MEMORY load per platform (Fig. 9's swap-cliff knob)
    bg_mem: Dict[str, float] = field(default_factory=dict)
    # (object key, destination store) pairs migrated before load starts —
    # the §5.1.4 adaptive data-management move the fig11 arms A/B
    migrate_objects: Tuple[Tuple[str, str], ...] = ()
    # flight recorder (the observability layer, not ported yet):
    # per-invocation lifecycle tracing and the report's latency_breakdown
    # section; trace_sample < 1 keeps a deterministic head-based subset of
    # invocations
    trace: bool = False
    trace_sample: float = 1.0
    # live telemetry (not ported yet): multi-resolution rollups,
    # burn-rate SLO alerting and platform-health anomaly detection.  A
    # dict mixing TelemetryConfig and AlertConfig keys (each picks the
    # keys it knows), or None to leave the engine off
    telemetry: Optional[Dict[str, Any]] = None
    # per-tenant QoS + overload resilience (repro_torch.core.qos): a
    # QosSpec or its dict form — class weights (DRR queue draining),
    # per-class SLO multipliers, token-bucket rate limits, load-shedding /
    # brownout thresholds.  None leaves admission and queues exactly as before
    qos: Optional[Union[QosSpec, Dict[str, Any]]] = None
    # decision provenance (not ported yet): journal every fused
    # fn_decisions admission (feature snapshot, filter-kill bitmask,
    # runner-up margin), stamp journal row ids onto invocations, and
    # surface the calibration/regret analysis as the report's
    # decision_provenance section.  Off by default (zero per-burst cost)
    provenance: bool = False
    # typed-spec constructor aliases (normalized into the flat fields
    # above, so the serialized spec and goldens are identical either way)
    tracing: InitVar[Optional[TracingSpec]] = None
    autoscaling: InitVar[Optional[AutoscaleSpec]] = None

    def __post_init__(self, tracing: Optional[TracingSpec],
                      autoscaling: Optional[AutoscaleSpec]):
        if tracing is not None:
            object.__setattr__(self, "trace", bool(tracing.enabled))
            object.__setattr__(self, "trace_sample",
                               float(tracing.sample))
        if autoscaling is not None:
            object.__setattr__(self, "autoscale", autoscaling.to_dict())
        if isinstance(self.qos, QosSpec):
            object.__setattr__(self, "qos", self.qos.to_dict())

    def qos_spec(self) -> Optional[QosSpec]:
        return None if self.qos is None else QosSpec.from_dict(self.qos)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


def _make_policy(name: str, kwargs: Dict[str, Any], cp: FDNControlPlane):
    kw = dict(kwargs or {})
    if name == "perf_ranked":
        return PerformanceRankedPolicy(cp.perf)
    if name == "utilization_aware":
        return UtilizationAwarePolicy(cp.perf, **kw)
    if name == "round_robin":
        return RoundRobinCollaboration()
    if name == "weighted":
        return WeightedCollaboration(kw.get("weights", {}))
    if name == "data_locality":
        return DataLocalityPolicy(cp.perf, cp.placement)
    if name == "warm_aware":
        return WarmAwarePolicy(cp.perf, cp.placement)
    if name == "energy_aware":
        return EnergyAwarePolicy(cp.perf)
    if name == "slo_composite":
        return SLOCompositePolicy(cp.perf, cp.placement, **kw)
    raise KeyError(f"unknown policy {name!r}")


PLATFORM_CATALOG: Dict[str, Any] = {**prof_mod.PAPER_PLATFORMS,
                                    **prof_mod.TPU_PLATFORMS}


def assemble(sc: Scenario, device: DeviceLike = None):
    """Build the control plane a scenario describes (mirrors the harness
    every hand-wired benchmark used to copy: five-platform FDN, Table-2
    functions, seeded MinIO stores, remote us-east replica). The function
    bodies and store objects live on ``device``."""
    cp = FDNControlPlane(enable_hedging=sc.enable_hedging,
                         predictive_prewarm=sc.predictive_prewarm,
                         retain_completions=sc.retain_objects)
    # without retain_objects the only per-invocation survivors of a run
    # are the sink's NumPy columns (no completed-Invocation list, no
    # knowledge-base decision rows — counters only)
    cp.kb.log_decisions = sc.retain_objects
    cp.policy = _make_policy(sc.policy, sc.policy_kwargs, cp)
    for name in sc.platforms:
        prof = PLATFORM_CATALOG[name]
        if sc.keepalive_w_per_replica > 0.0:
            prof = dataclasses.replace(
                prof, warm_w_per_replica=sc.keepalive_w_per_replica)
        cp.create_platform(prof)
    for name, bg in sc.bg_cpu.items():
        cp.platforms[name].bg_cpu = float(bg)
    for name, bg in sc.bg_mem.items():
        cp.platforms[name].bg_mem = float(bg)
    fns = fn_mod.paper_functions(IMAGE_KEY, JSON_KEY, device=device)
    if sc.analytic:
        fns = {k: f.replace(real_fn=None) for k, f in fns.items()}
    # chain workloads bring their own stage functions and data anchors
    for w in sc.workloads:
        if w.mode != "chain":
            continue
        tmpl = chain_catalog.get(w.chain)
        for fname, spec in tmpl.functions.items():
            if sc.analytic:
                spec = spec.replace(real_fn=None)
            fns.setdefault(fname, spec)
        for inp in tmpl.inputs:
            loc = inp.location or sc.data_location
            if loc not in cp.placement.stores:
                cp.placement.add_store(loc)
            cp.placement.stores[loc].put(inp.key, inp.size_bytes)
    for fname, p90_s in sc.slo_overrides.items():
        fns[fname] = fns[fname].replace(slo=SLO(p90_response_s=p90_s))
    fn_mod.seed_object_stores(cp.placement, IMAGE_KEY, JSON_KEY,
                              location=sc.data_location, device=device)
    cp.placement.add_store(REMOTE_STORE)
    fn_mod.seed_object_stores(cp.placement, IMAGE_KEY, JSON_KEY,
                              location=REMOTE_STORE, device=device)
    for name in sc.platforms:
        cp.placement.set_bandwidth(name, REMOTE_STORE, REMOTE_BW)
    for a, b, bw in sc.bandwidths:
        cp.placement.set_bandwidth(a, b, float(bw))
    for key, dest in sc.migrate_objects:
        cp.placement.migrate(key, dest)
    cp.deploy(DeploymentSpec(sc.name, list(fns.values()),
                             list(sc.platforms)))
    if sc.autoscale is not None:
        kw = dict(sc.autoscale)
        cp.attach_autoscaler(
            policy=kw.pop("policy", "predictive"),
            tick_s=float(kw.pop("tick_s", 1.0)),
            backend=kw.pop("backend", None),
            policy_kwargs=kw.pop("policy_kwargs", None))
        if kw:
            raise ValueError(f"unknown autoscale keys: {sorted(kw)}")
    # the observability layer is not ported yet: its attach points raise
    # NotImplementedError, naming their ROADMAP.md item
    if sc.trace:
        cp.attach_recorder(None)
    if sc.telemetry is not None:
        cp.attach_telemetry(None)
    if sc.qos is not None:
        # after telemetry: the admission controller's burn-rate overload
        # signal reads cp.telemetry rollups when configured
        cp.attach_qos(sc.qos_spec())
    if sc.provenance:
        cp.attach_provenance(None)
    attach_completion_hooks(cp)
    gw = Gateway(cp)
    if sc.lb_policy is not None:
        gw.lb_policy = _make_policy(sc.lb_policy, sc.lb_kwargs, cp)
    sink = ColumnarResultSink().install(cp)
    if sc.defer_metrics:
        cp.metrics.defer_completions = True
    return cp, gw, fns, sink


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------

@dataclass
class ScenarioReport:
    schema_version: int
    scenario: Dict[str, Any]
    totals: Dict[str, Any]
    per_platform: Dict[str, Dict[str, Any]]
    per_function: Dict[str, Dict[str, Any]]
    # chain workloads only: per-label end-to-end latency percentiles,
    # bytes moved between platforms, and the planner's placement decision
    per_chain: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    # flight-recorder runs only: segment decomposition totals, exact-
    # reconciliation counters, and SLO-violation attribution (the
    # observability layer, not ported yet: always empty here)
    latency_breakdown: Dict[str, Any] = field(default_factory=dict)
    # telemetry runs only: rollup summary, burn-rate SLO alert events and
    # platform-health anomalies (not ported yet: always empty here)
    alerts: Dict[str, Any] = field(default_factory=dict)
    # QoS runs only: per-class / per-tenant latency + class-adjusted SLO
    # stats, DRR fairness shares and the admission controller's shed /
    # degrade / spillover / brownout counters (repro_torch.core.qos)
    qos: Dict[str, Any] = field(default_factory=dict)
    # provenance runs only: decision-journal calibration (predicted-vs-
    # realized latency error), filter kill counts, regret and policy
    # churn (not ported yet: always empty here)
    decision_provenance: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        """Canonical serialization: sorted keys, no whitespace — two runs
        of one scenario must produce byte-identical strings."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    REQUIRED_TOTALS = ("submitted", "completed", "rejected", "cold_starts",
                       "cold_start_rate", "idle_wh",
                       "idle_wh_per_completion",
                       "slo_violations", "slo_violation_rate", "decisions",
                       "decisions_per_sim_s", "sim_duration_s",
                       "energy_wh")
    REQUIRED_STATS = ("completed", "mean_s", "p50_s", "p90_s", "p99_s")
    REQUIRED_CHAIN = ("launched", "completed", "p50_s", "p90_s", "p99_s",
                      "bytes_moved", "transfer_s", "placement", "mode")

    @classmethod
    def validate(cls, d: Dict[str, Any]) -> None:
        """Schema check for CI smoke tests; raises ValueError on drift."""
        if d.get("schema_version") != SCHEMA_VERSION:
            raise ValueError(f"schema_version != {SCHEMA_VERSION}: "
                             f"{d.get('schema_version')!r}")
        for section in ("scenario", "totals", "per_platform",
                        "per_function"):
            if not isinstance(d.get(section), dict):
                raise ValueError(f"missing section {section!r}")
        for k in cls.REQUIRED_TOTALS:
            if k not in d["totals"]:
                raise ValueError(f"totals missing {k!r}")
        for section in ("per_platform", "per_function"):
            for name, stats in d[section].items():
                for k in cls.REQUIRED_STATS:
                    if k not in stats:
                        raise ValueError(
                            f"{section}[{name!r}] missing {k!r}")
        # per_chain is additive (pre-chain reports omit it entirely)
        for name, stats in d.get("per_chain", {}).items():
            for k in cls.REQUIRED_CHAIN:
                if k not in stats:
                    raise ValueError(f"per_chain[{name!r}] missing {k!r}")
        # latency_breakdown is additive too ({} on untraced runs)
        lb = d.get("latency_breakdown", {})
        if not isinstance(lb, dict):
            raise ValueError("latency_breakdown must be a dict")
        if lb:
            for k in ("segment_totals_s", "slo_attribution",
                      "exact_reconciled"):
                if k not in lb:
                    raise ValueError(f"latency_breakdown missing {k!r}")
        # alerts is additive too ({} when the telemetry engine is off)
        al = d.get("alerts", {})
        if not isinstance(al, dict):
            raise ValueError("alerts must be a dict")
        if al:
            for k in ("enabled", "rollup", "slo", "health"):
                if k not in al:
                    raise ValueError(f"alerts missing {k!r}")
        # qos is additive too ({} when no QosSpec is attached)
        q = d.get("qos", {})
        if not isinstance(q, dict):
            raise ValueError("qos must be a dict")
        if q:
            for k in ("per_class", "per_tenant", "fairness", "admission"):
                if k not in q:
                    raise ValueError(f"qos missing {k!r}")
        # decision_provenance is additive too ({} when the journal is off)
        dp = d.get("decision_provenance", {})
        if not isinstance(dp, dict):
            raise ValueError("decision_provenance must be a dict")
        if dp:
            for k in ("policy", "decisions", "kill_counts", "calibration",
                      "regret", "churn"):
                if k not in dp:
                    raise ValueError(f"decision_provenance missing {k!r}")


def _pct_stats(rt: np.ndarray, duration_s: float) -> Dict[str, Any]:
    return {
        "completed": int(rt.size),
        "mean_s": float(rt.mean()) if rt.size else float("nan"),
        "p50_s": percentile_unsorted(rt, 0.50),
        "p90_s": percentile_unsorted(rt, 0.90),
        "p99_s": percentile_unsorted(rt, 0.99),
        "rps": rt.size / max(duration_s, 1e-9),
    }


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

class ScenarioRun:
    """Everything behind a scenario run, by name: ``.report``,
    ``.control_plane``, ``.sink``, plus the attached ``.telemetry`` engine
    and flight ``.recorder`` (None when the scenario left them off).

    Iterates and indexes as the historical ``(report, control_plane,
    sink)`` 3-tuple, so ``report, cp, sink = run_scenario_state(sc)`` and
    ``run_scenario_state(sc)[0]`` keep working unchanged."""

    __slots__ = ("report", "control_plane", "sink", "telemetry",
                 "recorder", "journal")

    def __init__(self, report: ScenarioReport, control_plane:
                 FDNControlPlane, sink: ColumnarResultSink):
        self.report = report
        self.control_plane = control_plane
        self.sink = sink
        self.telemetry = control_plane.telemetry
        self.recorder = control_plane.recorder
        self.journal = control_plane.journal

    def _as_tuple(self):
        return (self.report, self.control_plane, self.sink)

    def __iter__(self):
        return iter(self._as_tuple())

    def __getitem__(self, i):
        return self._as_tuple()[i]

    def __len__(self) -> int:
        return 3


def run_scenario(sc: Scenario, device: DeviceLike = None) -> ScenarioReport:
    return run_scenario_state(sc, device).report


def run_scenario_state(sc: Scenario, device: DeviceLike = None
                       ) -> "ScenarioRun":
    """``run_scenario`` returning a ``ScenarioRun`` — for callers (fig6/
    fig8 benchmarks, tests) that need the metric series or platform state
    behind the report, not just the canonical summary.  Unpacks as the
    legacy ``(report, control_plane, sink)`` tuple.  The function bodies
    and store objects live on ``device`` (the card unless the caller asks
    for the CPU)."""
    cp, gw, fns, sink = assemble(sc, device)
    clock = cp.clock

    for ev in sc.faults:
        p = cp.platforms[ev.platform]
        clock.schedule(ev.t, p.fail if ev.action == "fail" else p.recover)

    if sc.platform_override is not None:
        po = sc.platform_override

        def submit(inv: Invocation) -> bool:
            return cp.submit(inv, platform_override=po)

        def submit_batch(invs: List[Invocation]) -> int:
            return cp.submit_batch(invs, platform_override=po)
    else:
        submit, submit_batch = gw.request, gw.request_batch

    # one derived seed per load stream: deterministic, decorrelated
    closed_out: List[Invocation] = []
    mix = traces.WorkloadMix()
    chain_exec: Optional[ChainExecutor] = None
    planner: Optional[DataGravityPlanner] = None
    last_chain_t = 0.0
    for i, w in enumerate(sc.workloads):
        stream_seed = sc.seed + 7919 * i
        if w.mode == "closed":
            spawn_vus(clock, submit, fns[w.function], w.vus,
                      t_end=sc.duration_s, sleep_s=w.sleep_s,
                      seed=stream_seed, jitter=w.jitter, out=closed_out,
                      qos=qos_id(w.qos_class), tenant=w.tenant)
        elif w.mode == "open":
            if w.arrival is None:
                raise ValueError(f"open workload {w.function!r} "
                                 "needs an arrival spec")
            mix.add(w.function,
                    traces.build_arrivals(w.arrival, sc.duration_s,
                                          seed=stream_seed),
                    qos=qos_id(w.qos_class), tenant=w.tenant)
        elif w.mode == "chain":
            if w.chain is None or w.arrival is None:
                raise ValueError("chain workload needs a chain name and "
                                 "an arrival spec")
            if chain_exec is None:
                chain_exec = cp.chain_executor(
                    fns, sink=sink, batch_window_s=sc.batch_window_s)
                planner = DataGravityPlanner(cp.policy, cp.placement, fns)
            chain = chain_catalog.get(w.chain).chain
            plan = planner.plan(chain,
                                [cp.platforms[n] for n in sc.platforms],
                                mode=w.plan_mode)
            label = w.label or f"{w.chain}@{w.plan_mode}"
            arr = traces.build_arrivals(w.arrival, sc.duration_s,
                                        seed=stream_seed)
            if arr.size:
                last_chain_t = max(last_chain_t, float(arr[-1]))
                clock.schedule_many(
                    arr.tolist(),
                    [lambda c=chain, p=plan, l=label:
                     chain_exec.launch(c, p, label=l)] * arr.size)
        else:
            raise ValueError(f"unknown workload mode {w.mode!r}")

    times, fn_idx, names, qos_col, tenant_col = mix.merge_tagged()
    specs = [fns[n] for n in names]
    schedule_arrival_mix(clock, submit_batch, specs, times, fn_idx,
                         sc.batch_window_s, sink, columnar=sc.columnar,
                         qos=qos_col, tenant=tenant_col)

    t_end = max(sc.duration_s,
                float(times[-1]) if times.size else 0.0,
                last_chain_t)
    clock.run_until(t_end)
    clock.run_until(t_end + sc.drain_s)      # gracefulStop
    cp.run_until(clock.now())                # flush energy integrators

    visible = {name: p.prof.infra_metrics_visible
               for name, p in cp.platforms.items()}
    if sc.defer_metrics:
        cp.metrics.defer_completions = False
        cp.metrics.record_completions(sink, visible_infra=visible)

    report = build_report(sc, cp, fns, sink,
                          closed_submitted=len(closed_out),
                          chain_exec=chain_exec)
    return ScenarioRun(report, cp, sink)


def build_report(sc: Scenario, cp: FDNControlPlane, fns,
                 sink: ColumnarResultSink,
                 closed_submitted: int = 0,
                 chain_exec: Optional[ChainExecutor] = None
                 ) -> ScenarioReport:
    cols = sink.completion_columns()
    rt = cols["end"] - cols["arrival"]
    plat_col, fn_col, cold = cols["platform"], cols["fn"], cols["cold"]

    # SLO thresholds broadcast per completion via the fn-id column
    slo_by_fid = np.full(max(len(cols["fn_ids"]), 1), np.inf)
    for fname, fid in cols["fn_ids"].items():
        slo_by_fid[fid] = fns[fname].slo.p90_response_s
    violated = rt > slo_by_fid[fn_col] if rt.size else \
        np.empty(0, bool)

    per_platform: Dict[str, Dict[str, Any]] = {}
    for pname in sc.platforms:
        pid = cols["platform_ids"].get(pname)
        mask = (plat_col == pid) if pid is not None else \
            np.zeros(rt.size, bool)
        stats = _pct_stats(rt[mask], sc.duration_s)
        n_cold = int(cold[mask].sum())
        n_done = int(mask.sum())
        stats["cold_starts"] = n_cold
        stats["cold_start_rate"] = n_cold / n_done if n_done else 0.0
        stats["slo_violations"] = int(violated[mask].sum())
        joules = cp.energy.joules(pname)
        idle_j = cp.energy.keepalive_joules(pname)
        stats["energy_j"] = float(joules)
        stats["energy_wh"] = float(joules) / 3600.0
        stats["idle_wh"] = float(idle_j) / 3600.0
        stats["idle_wh_per_completion"] = \
            float(idle_j) / 3600.0 / n_done if n_done else 0.0
        per_platform[pname] = stats

    per_function: Dict[str, Dict[str, Any]] = {}
    for fname, fid in cols["fn_ids"].items():
        mask = fn_col == fid
        stats = _pct_stats(rt[mask], sc.duration_s)
        n_cold = int(cold[mask].sum())
        stats["cold_starts"] = n_cold
        stats["cold_start_rate"] = (n_cold / int(mask.sum())
                                    if mask.any() else 0.0)
        n_violated = int(violated[mask].sum())
        stats["slo_violations"] = n_violated
        stats["slo_violation_rate"] = (n_violated / int(mask.sum())
                                       if mask.any() else 0.0)
        stats["slo_s"] = float(fns[fname].slo.p90_response_s)
        per_function[fname] = stats

    submitted = sink.submitted + closed_submitted
    rejected = cp.rejected_count
    n_violations = int(violated.sum()) + rejected
    decisions = cp.kb.decision_count
    idle_wh = float(sum(p["idle_wh"] for p in per_platform.values()))
    totals = {
        "submitted": submitted,
        "completed": sink.completed,
        "rejected": rejected,
        "cold_starts": int(cold.sum()),
        "cold_start_rate": (int(cold.sum()) / sink.completed
                            if sink.completed else 0.0),
        "slo_violations": n_violations,
        "slo_violation_rate": n_violations / max(submitted, 1),
        "decisions": decisions,
        "decisions_per_sim_s": decisions / max(sc.duration_s, 1e-9),
        "sim_duration_s": float(sc.duration_s),
        "energy_wh": float(sum(p["energy_wh"]
                               for p in per_platform.values())),
        "idle_wh": idle_wh,
        "idle_wh_per_completion": (idle_wh / sink.completed
                                   if sink.completed else 0.0),
        "redelivered": cp.redeliverer.redelivered,
        "hedges_sent": cp.hedge.hedges_sent,
    }
    totals.update(_pct_stats(rt, sc.duration_s))
    if cp.autoscaler is not None:
        totals["autoscale"] = {
            "policy": cp.autoscaler.policy.name,
            "ticks": cp.autoscaler.ticks,
            "prewarmed": cp.autoscaler.prewarmed,
            "retired": cp.autoscaler.retired,
        }

    per_chain: Dict[str, Dict[str, Any]] = {}
    if chain_exec is not None:
        for label, recs in chain_exec.records.items():
            lat = np.array([r[1] - r[0] for r in recs])
            plan = chain_exec.plans[label]
            stats = _pct_stats(lat, sc.duration_s)
            stats["launched"] = chain_exec.launched_by_label.get(label, 0)
            stats["bytes_moved"] = float(sum(r[2] for r in recs))
            stats["transfer_s"] = float(sum(r[3] for r in recs))
            stats["mode"] = plan.mode
            stats["requested_mode"] = plan.requested_mode
            stats["placement"] = dict(plan.assignment)
            stats["est_makespan_s"] = plan.est_makespan_s
            per_chain[label] = stats
        totals["chains_launched"] = chain_exec.launched
        totals["chains_completed"] = chain_exec.completed
        totals["chains_failed"] = chain_exec.failed

    # the recorder, telemetry and journal sections come with the
    # observability layer, which is not ported yet: its attach points raise,
    # so no run has a recorder, telemetry engine or journal to report
    latency_breakdown: Dict[str, Any] = {}
    alerts: Dict[str, Any] = {}
    provenance: Dict[str, Any] = {}

    qos_section: Dict[str, Any] = {}
    qspec = sc.qos_spec()
    if qspec is not None:
        qos_section = _qos_section(qspec, cp, cols, rt, slo_by_fid,
                                   sc.duration_s)

    return ScenarioReport(schema_version=SCHEMA_VERSION,
                          scenario=sc.to_dict(), totals=totals,
                          per_platform=per_platform,
                          per_function=per_function,
                          per_chain=per_chain,
                          latency_breakdown=latency_breakdown,
                          alerts=alerts,
                          qos=qos_section,
                          decision_provenance=provenance)


def _qos_section(spec: QosSpec, cp: FDNControlPlane,
                 cols: Dict[str, Any], rt: np.ndarray,
                 slo_by_fid: np.ndarray,
                 duration_s: float) -> Dict[str, Any]:
    """Per-class / per-tenant latency and class-adjusted SLO stats.

    A class's effective deadline is the function SLO scaled by its
    multiplier (latency_critical tightens it, batch relaxes it), so the
    violation counts here answer "did each class meet *its own* bar",
    not the flat per-function question ``totals`` already answers."""
    qcol, tcol, fn_col = cols["qos"], cols["tenant"], cols["fn"]
    mults = np.asarray(spec.slo_multipliers, np.float64)
    adj_violated = (rt > slo_by_fid[fn_col] * mults[qcol]) if rt.size \
        else np.empty(0, bool)
    total = max(int(rt.size), 1)

    per_class: Dict[str, Dict[str, Any]] = {}
    share: Dict[str, float] = {}
    for c in range(N_QOS):
        mask = qcol == c
        n = int(mask.sum())
        stats = _pct_stats(rt[mask], duration_s)
        n_viol = int(adj_violated[mask].sum())
        stats["slo_multiplier"] = float(mults[c])
        stats["slo_violations"] = n_viol
        stats["slo_violation_rate"] = n_viol / n if n else 0.0
        stats["weight"] = int(spec.weights[c])
        stats["served_share"] = n / total
        per_class[QOS_NAMES[c]] = stats
        share[QOS_NAMES[c]] = n / total

    per_tenant: Dict[str, Dict[str, Any]] = {}
    for t in (np.unique(tcol) if tcol.size else ()):
        mask = tcol == t
        n = int(mask.sum())
        per_tenant[str(int(t))] = {
            "completed": n,
            "served_share": n / total,
            "p99_s": percentile_unsorted(rt[mask], 0.99),
            "slo_violations": int(adj_violated[mask].sum()),
        }

    adm = cp.admission.section() if cp.admission is not None else {}
    return {
        "per_class": per_class,
        "per_tenant": per_tenant,
        "fairness": {"weights": [int(w) for w in spec.weights],
                     "drr_enabled": spec.drr_enabled(),
                     "served_share": share},
        "admission": adm,
    }
