"""Scenario registry: the paper's figure/table experiments re-expressed as
declarative FDNInspector scenarios, plus scenarios the hand-wired
benchmarks could not express (multi-function mixes across five platforms,
energy sweeps under diurnal load, MMPP burst storms, mid-run platform
outages, overload ramps, Azure-style minute-count replay).

``get(name)`` builds a fresh ``Scenario``; ``names()`` lists everything
registered.  The parameterized ``fig5_cell`` / ``fig7_cell`` /
``fig10_scenario`` / ``table4_cell`` factories are what the migrated
``benchmarks/fig*.py`` modules iterate over.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.inspector import traces
from repro_torch.inspector.scenario import (IMAGE_KEY, REMOTE_STORE,
                                            FaultEvent, Scenario, Workload)

PAPER_FIVE = ("hpc-node-cluster", "old-hpc-node-cluster", "cloud-cluster",
              "google-cloud-cluster", "edge-cluster")

_FACTORIES: Dict[str, Callable[[], Scenario]] = {}


def register(name: str, factory: Callable[[], Scenario]) -> None:
    _FACTORIES[name] = factory


def names() -> List[str]:
    return sorted(_FACTORIES)


def get(name: str) -> Scenario:
    if name not in _FACTORIES:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {', '.join(names())}")
    return _FACTORIES[name]()


# ---------------------------------------------------------------------------
# Paper experiments as scenario families (benchmarks/fig*.py iterate these)
# ---------------------------------------------------------------------------

def fig5_cell(platform: str, vus: int, duration_s: float = 120.0,
              analytic: bool = False) -> Scenario:
    """Fig. 5: nodeinfo, exclusive on one platform, closed-loop VUs."""
    return Scenario(
        name=f"fig5/nodeinfo/{platform}/vus{vus}",
        platforms=PAPER_FIVE,
        workloads=(Workload("nodeinfo", mode="closed", vus=vus,
                            sleep_s=0.05),),
        duration_s=duration_s, platform_override=platform,
        analytic=analytic)


def fig7_cell(platform: str, function: str, duration_s: float = 120.0,
              analytic: bool = False) -> Scenario:
    """Fig. 7: function heterogeneity at 30 VUs on one platform."""
    return Scenario(
        name=f"fig7/{function}/{platform}/vus30",
        platforms=PAPER_FIVE,
        workloads=(Workload(function, mode="closed", vus=30,
                            sleep_s=0.2),),
        duration_s=duration_s, platform_override=platform,
        analytic=analytic)


def fig10_scenario(mode: str, duration_s: float = 120.0,
                   analytic: bool = False) -> Scenario:
    """Fig. 10: primes-python at 40 VUs over old-hpc + cloud — exclusive
    arms or gateway collaboration (round-robin / weighted 5:1)."""
    pair = ("old-hpc-node-cluster", "cloud-cluster")
    wl = (Workload("primes-python", mode="closed", vus=40, sleep_s=0.05),)
    base = dict(platforms=pair, workloads=wl, duration_s=duration_s,
                analytic=analytic)
    if mode in pair:
        return Scenario(name=f"fig10/exclusive/{mode}",
                        platform_override=mode, **base)
    if mode == "round_robin":
        return Scenario(name="fig10/round_robin", lb_policy="round_robin",
                        **base)
    if mode == "weighted":
        return Scenario(name="fig10/weighted_5to1", lb_policy="weighted",
                        lb_kwargs={"weights": {"old-hpc-node-cluster": 5,
                                               "cloud-cluster": 1}},
                        **base)
    raise KeyError(f"unknown fig10 mode {mode!r}")


def fig6_cell(platform: str, duration_s: float = 120.0,
              analytic: bool = False) -> Scenario:
    """Fig. 6: nodeinfo at 20 VUs, exclusive on one platform — the Table-1
    metric-detail run (same drive as ``fig5_cell`` at 20 VUs; the fig6
    benchmark reads the metric *series* behind the report via
    ``run_scenario_state``)."""
    return Scenario(
        name=f"fig6/nodeinfo/{platform}/vus20",
        platforms=PAPER_FIVE,
        workloads=(Workload("nodeinfo", mode="closed", vus=20,
                            sleep_s=0.05),),
        duration_s=duration_s, platform_override=platform,
        analytic=analytic)


def fig8_cell(bg_cpu: float, duration_s: float = 120.0,
              analytic: bool = False) -> Scenario:
    """Fig. 8: image-processing at 40 VUs on old-hpc with background CPU
    load in {0%, 50%, 100%} (the §5.1.2 interference knob)."""
    platform = "old-hpc-node-cluster"
    return Scenario(
        name=f"fig8/image-processing/bg_cpu{int(bg_cpu * 100)}",
        platforms=PAPER_FIVE,
        workloads=(Workload("image-processing", mode="closed", vus=40,
                            sleep_s=0.5),),
        duration_s=duration_s, platform_override=platform,
        data_location=platform, bg_cpu={platform: bg_cpu},
        analytic=analytic)


def fig9_cell(bg_mem: float, duration_s: float = 120.0,
              analytic: bool = False) -> Scenario:
    """Fig. 9: image-processing at 40 VUs on old-hpc with background
    MEMORY load in {0%, 50%, 100%} — the swap-cliff twin of fig8."""
    platform = "old-hpc-node-cluster"
    return Scenario(
        name=f"fig9/image-processing/bg_mem{int(bg_mem * 100)}",
        platforms=PAPER_FIVE,
        workloads=(Workload("image-processing", mode="closed", vus=40,
                            sleep_s=0.5),),
        duration_s=duration_s, platform_override=platform,
        data_location=platform, bg_mem={platform: bg_mem},
        analytic=analytic)


FIG11_ARMS = {
    # variant -> (compute platform, data location, pre-run migrations)
    "cloud-local-minio": ("cloud-cluster", "cloud-cluster", ()),
    "cloud-remote-minio": ("cloud-cluster", REMOTE_STORE, ()),
    "gcf-near-data": ("google-cloud-cluster", REMOTE_STORE, ()),
    "cloud-after-migration": ("cloud-cluster", REMOTE_STORE,
                              ((IMAGE_KEY, "cloud-cluster"),)),
}


def fig11_cell(variant: str, duration_s: float = 120.0,
               analytic: bool = False) -> Scenario:
    """Fig. 11: image-processing at 20 VUs — local vs remote MinIO vs
    compute-near-data vs migrate-then-run (§5.1.4 adaptive data
    management).  With ``data_location=REMOTE_STORE`` the runner seeds the
    object at the remote store ONLY, so the remote arms read across the
    WAN by construction."""
    platform, data_loc, migrations = FIG11_ARMS[variant]
    return Scenario(
        name=f"fig11/{variant}",
        platforms=PAPER_FIVE,
        workloads=(Workload("image-processing", mode="closed", vus=20,
                            sleep_s=0.2),),
        duration_s=duration_s, platform_override=platform,
        data_location=data_loc, migrate_objects=migrations,
        analytic=analytic)


SWEEP_POLICIES = ("perf_ranked", "utilization_aware", "round_robin",
                  "energy_aware", "slo_composite")
SWEEP_FNS = ("nodeinfo", "primes-python", "JSON-loads", "image-processing")


def policy_sweep_cell(policy: str, duration_s: float = 90.0,
                      analytic: bool = True) -> Scenario:
    """One arm of the all-policy head-to-head: four closed-loop function
    streams over the five platforms under ``policy`` (deterministic
    per-stream seeds come from the runner — the old hand-wired sweep
    seeded VU pools with salted ``hash(fn)``)."""
    return Scenario(
        name=f"sweep/{policy}",
        platforms=PAPER_FIVE,
        workloads=tuple(Workload(fn, mode="closed", vus=8, sleep_s=0.1)
                        for fn in SWEEP_FNS),
        duration_s=duration_s, policy=policy, analytic=analytic)


def policy_sweep_open_loop(duration_s: float = 90.0,
                           rps: float = 60.0) -> Scenario:
    """The sweep's open-loop arm: Poisson nodeinfo through the batched
    gateway path under the composite policy (burst admission must hold
    the SLO too)."""
    return Scenario(
        name="sweep/slo_composite-open-loop",
        platforms=PAPER_FIVE,
        workloads=(Workload("nodeinfo",
                            arrival={"kind": "poisson", "rps": rps}),),
        duration_s=duration_s, batch_window_s=0.1)


def table4_cell(platform: str, duration_s: float = 600.0, rps: float = 40.0,
                analytic: bool = False) -> Scenario:
    """Table 4: JSON-loads at a fixed open-loop arrival rate, exclusive on
    one platform, data local to that platform (energy comparison)."""
    return Scenario(
        name=f"table4/JSON-loads/{platform}",
        platforms=PAPER_FIVE,
        workloads=(Workload("JSON-loads", mode="open",
                            arrival={"kind": "uniform", "rps": rps}),),
        duration_s=duration_s, platform_override=platform,
        data_location=platform, batch_window_s=0.0, drain_s=60.0,
        analytic=analytic)


register("paper/fig5-hpc-vus20",
         lambda: fig5_cell("hpc-node-cluster", 20, analytic=True))
register("paper/fig7-primes-gcf",
         lambda: fig7_cell("google-cloud-cluster", "primes-python",
                           analytic=True))
register("paper/fig10-weighted",
         lambda: fig10_scenario("weighted", analytic=True))
register("paper/table4-edge",
         lambda: table4_cell("edge-cluster", analytic=True))
register("paper/table4-hpc",
         lambda: table4_cell("hpc-node-cluster", analytic=True))


# ---------------------------------------------------------------------------
# Beyond the hand-wired benchmarks
# ---------------------------------------------------------------------------

def five_platform_mix(duration_s: float = 120.0) -> Scenario:
    """All five Table-2 functions as concurrent Poisson streams over all
    five platforms under the production policy — the cross-function
    interference case no per-figure benchmark could express."""
    return Scenario(
        name="mix/five-platform",
        platforms=PAPER_FIVE,
        workloads=(
            Workload("nodeinfo",
                     arrival={"kind": "poisson", "rps": 40.0}),
            Workload("JSON-loads",
                     arrival={"kind": "poisson", "rps": 25.0}),
            Workload("image-processing",
                     arrival={"kind": "poisson", "rps": 6.0}),
            Workload("sentiment-analysis",
                     arrival={"kind": "poisson", "rps": 4.0}),
            Workload("primes-python",
                     arrival={"kind": "poisson", "rps": 2.0}),
        ),
        duration_s=duration_s)


def edge_vs_cloud_energy(duration_s: float = 600.0) -> Scenario:
    """Table-4's question under realistic load: a diurnal JSON-loads cycle
    over edge + hpc with the energy-aware policy free to choose."""
    return Scenario(
        name="energy/edge-vs-cloud-diurnal",
        platforms=("edge-cluster", "hpc-node-cluster"),
        workloads=(
            Workload("JSON-loads",
                     arrival={"kind": "diurnal", "mean_rps": 25.0,
                              "period_s": 600.0, "peak_frac": 0.8}),
            Workload("nodeinfo",
                     arrival={"kind": "diurnal", "mean_rps": 10.0,
                              "period_s": 600.0, "peak_frac": 0.8}),
        ),
        duration_s=duration_s, policy="energy_aware",
        data_location="hpc-node-cluster")


def burst_storm(duration_s: float = 120.0) -> Scenario:
    """MMPP burst storm against ``submit_batch``: quiet baseline
    punctuated by 600 rps bursts, admitted in 50 ms batched windows."""
    return Scenario(
        name="burst/mmpp-storm",
        platforms=PAPER_FIVE,
        workloads=(
            Workload("nodeinfo",
                     arrival={"kind": "mmpp", "base_rps": 30.0,
                              "burst_rps": 600.0, "mean_quiet_s": 15.0,
                              "mean_burst_s": 3.0}),
            Workload("JSON-loads",
                     arrival={"kind": "mmpp", "base_rps": 15.0,
                              "burst_rps": 300.0, "mean_quiet_s": 20.0,
                              "mean_burst_s": 2.0}),
        ),
        duration_s=duration_s)


def platform_outage(duration_s: float = 120.0) -> Scenario:
    """Mid-run outage of the fastest platform: hpc fails at t=40 s and
    recovers at t=80 s while a mixed load keeps arriving (redelivery +
    failure detector + elastic re-admission, §3.1.3)."""
    return Scenario(
        name="faults/hpc-outage",
        platforms=("hpc-node-cluster", "cloud-cluster", "edge-cluster"),
        workloads=(
            Workload("nodeinfo",
                     arrival={"kind": "poisson", "rps": 30.0}),
            Workload("JSON-loads",
                     arrival={"kind": "poisson", "rps": 10.0}),
        ),
        duration_s=duration_s,
        faults=(FaultEvent(40.0, "hpc-node-cluster", "fail"),
                FaultEvent(80.0, "hpc-node-cluster", "recover")))


def ramp_overload(duration_s: float = 120.0) -> Scenario:
    """Linear overload ramp on the two weakest platforms: the
    sentiment-analysis arrival rate climbs past their aggregate capacity
    (~70 rps), exposing queueing growth and the SLO-violation knee."""
    return Scenario(
        name="ramp/overload",
        platforms=("cloud-cluster", "edge-cluster"),
        workloads=(
            Workload("sentiment-analysis",
                     arrival={"kind": "ramp", "start_rps": 5.0,
                              "end_rps": 160.0}),
        ),
        duration_s=duration_s,
        slo_overrides={"sentiment-analysis": 2.0})


def azure_replay(duration_s: float = 300.0) -> Scenario:
    """Azure-Functions-style minute-count replay: three synthetic
    per-minute count rows (diurnal-shaped, seeded) expanded to arrivals
    and time-dilated so a 60-minute trace plays in 300 s."""
    counts = traces.synthetic_azure_counts(
        ["nodeinfo", "JSON-loads", "image-processing"], minutes=60,
        mean_rpm=240.0, seed=11)
    scale = duration_s / 3600.0
    return Scenario(
        name="azure/minute-replay",
        platforms=PAPER_FIVE,
        workloads=tuple(
            Workload(fn, arrival={"kind": "azure",
                                  "counts": counts[fn].tolist(),
                                  "time_scale": scale,
                                  "duration_s": duration_s})
            for fn in counts),
        duration_s=duration_s)


def million_burst(n_target: int = 1_000_000) -> Scenario:
    """Scale demonstration: ~10^6 invocations through the columnar
    pipeline (Poisson mix at ~1700 rps over 600 s across five platforms).
    Per-invocation survivors of the run are NumPy columns only — no
    completed-Invocation list, no decision rows (``retain_objects`` stays
    False).  Takes a minute or two of wall time; not part of CI."""
    duration = 600.0
    total_rps = n_target / duration
    return Scenario(
        name="scale/million-burst",
        platforms=PAPER_FIVE,
        workloads=(
            Workload("nodeinfo",
                     arrival={"kind": "poisson",
                              "rps": 0.7 * total_rps}),
            Workload("JSON-loads",
                     arrival={"kind": "mmpp",
                              "base_rps": 0.2 * total_rps,
                              "burst_rps": 0.6 * total_rps,
                              "mean_quiet_s": 20.0, "mean_burst_s": 5.0}),
        ),
        duration_s=duration)


def smoke_tiny() -> Scenario:
    """CI smoke: a 10-second two-platform mixed scenario (closed + open)
    exercising every runner path in well under a second."""
    return Scenario(
        name="smoke/tiny",
        platforms=("hpc-node-cluster", "cloud-cluster"),
        workloads=(
            Workload("nodeinfo",
                     arrival={"kind": "poisson", "rps": 20.0}),
            Workload("JSON-loads", mode="closed", vus=4, sleep_s=0.05),
        ),
        duration_s=10.0, drain_s=30.0)


# ---------------------------------------------------------------------------
# Function chains (collaborative execution + data gravity, repro_torch.chains)
# ---------------------------------------------------------------------------

def chain_etl(duration_s: float = 120.0) -> Scenario:
    """ETL chain instances (extract -> 4x transform -> aggregate -> load)
    planned by the data-gravity planner over the five platforms, riding
    alongside plain nodeinfo traffic."""
    return Scenario(
        name="chains/etl-pipeline",
        platforms=PAPER_FIVE,
        workloads=(
            Workload(mode="chain", chain="etl-pipeline",
                     arrival={"kind": "poisson", "rps": 2.0}),
            Workload("nodeinfo",
                     arrival={"kind": "poisson", "rps": 20.0}),
        ),
        duration_s=duration_s)


def chain_ml(duration_s: float = 120.0) -> Scenario:
    """Preprocess -> serve -> respond over the Table-2 functions: the
    paper's image/sentiment workloads composed into one application."""
    return Scenario(
        name="chains/ml-inference-preprocess-serve",
        platforms=PAPER_FIVE,
        workloads=(
            Workload(mode="chain", chain="ml-preprocess-serve",
                     arrival={"kind": "poisson", "rps": 3.0}),
            Workload("JSON-loads",
                     arrival={"kind": "poisson", "rps": 10.0}),
        ),
        duration_s=duration_s)


AB_PAIR = ("cloud-cluster", "old-hpc-node-cluster")


def split_vs_colocate(wan_bw: float = 2e9, duration_s: float = 120.0,
                      rps: float = 3.0, suffix: str = "") -> Scenario:
    """Collaborative split vs forced co-location A/B on the dual-source
    chain: both arms share the platform pair, the inter-platform
    bandwidth is the swept knob.  With a fast interconnect the split arm
    wins end-to-end p90 (the co-located arm queues on one platform); with
    a slow WAN the 16 MB of features crossing platforms flips the order.
    """
    return Scenario(
        name=f"chains/split-vs-colocate-ab{suffix}",
        platforms=AB_PAIR,
        policy="perf_ranked",
        bandwidths=((AB_PAIR[0], AB_PAIR[1], wan_bw),),
        workloads=(
            Workload(mode="chain", chain="ab-dual-source",
                     plan_mode="colocate", label="ab@colocate",
                     arrival={"kind": "poisson", "rps": rps}),
            Workload(mode="chain", chain="ab-dual-source",
                     plan_mode="split", label="ab@split",
                     arrival={"kind": "poisson", "rps": rps}),
        ),
        duration_s=duration_s)


# ---------------------------------------------------------------------------
# Prewarm-policy studies (warm-pool lifecycle, the autoscale layer; not
# ported yet: running one raises, naming ROADMAP.md Queue 1 item 5)
# ---------------------------------------------------------------------------

AUTOSCALE_PLATFORM = "cloud-cluster"
KEEPALIVE_W = 2.0                      # watts per idle warm replica

# one deep diurnal cycle every 600 s: the trough (rate -> 0) is where a
# fixed keep-alive must choose between dying (cold starts at the ramp)
# and idling (watts); ~6000 invocations over two cycles
DIURNAL_TRACE = {"kind": "diurnal", "mean_rps": 5.0, "period_s": 600.0,
                 "peak_frac": 1.0}
# sparse: one arrival every ~12 s — keep-alive is almost pure idle cost
SPARSE_TRACE = {"kind": "poisson", "rps": 0.08}
# MMPP burst storm: quiet baseline punctuated by short bursts, the
# recurrence-gap case the predictive TTL histogram is built to learn
BURST_TRACE = {"kind": "mmpp", "base_rps": 0.5, "burst_rps": 40.0,
               "mean_quiet_s": 45.0, "mean_burst_s": 3.0}

AUTOSCALE_POLICIES = {
    "ttl": {"policy": "ttl", "policy_kwargs": {"ttl_s": 60.0}},
    "ttl-short": {"policy": "ttl", "policy_kwargs": {"ttl_s": 15.0}},
    "scale-to-zero": {"policy": "scale_to_zero",
                      "policy_kwargs": {"idle_s": 2.0}},
    "concurrency": {"policy": "concurrency"},
    "predictive": {"policy": "predictive"},
}


def autoscale_cell(trace_name: str, policy_key: str,
                   duration_s: float) -> Scenario:
    """One arm of a prewarm-policy A/B: a single exclusive platform (so
    cold-start and idle-Wh effects are not confounded by routing), one
    trace, one keep-alive policy, idle keep-alive watts charged."""
    traces_by_name = {"diurnal": DIURNAL_TRACE, "sparse": SPARSE_TRACE,
                      "burst": BURST_TRACE}
    return Scenario(
        name=f"autoscale/{trace_name}-{policy_key}",
        platforms=(AUTOSCALE_PLATFORM,),
        platform_override=AUTOSCALE_PLATFORM,
        workloads=(Workload("nodeinfo",
                            arrival=dict(traces_by_name[trace_name])),),
        duration_s=duration_s, drain_s=30.0,
        keepalive_w_per_replica=KEEPALIVE_W,
        autoscale=dict(AUTOSCALE_POLICIES[policy_key]))


for _trace, _dur in (("diurnal", 1200.0), ("sparse", 600.0),
                     ("burst", 600.0)):
    for _pol in AUTOSCALE_POLICIES:
        register(f"autoscale/{_trace}-{_pol}",
                 lambda t=_trace, p=_pol, d=_dur: autoscale_cell(t, p, d))


register("chains/etl-pipeline", chain_etl)
register("chains/ml-inference-preprocess-serve", chain_ml)
register("chains/split-vs-colocate-ab", lambda: split_vs_colocate(2e9))
# slow WAN: 1 rps keeps both arms stable, so the p90 flip measures the
# transfer cost of gravity-blind splitting rather than queue collapse
register("chains/split-vs-colocate-ab-slowwan",
         lambda: split_vs_colocate(3e6, rps=1.0, suffix="-slowwan"))
register("mix/five-platform", five_platform_mix)
register("energy/edge-vs-cloud-diurnal", edge_vs_cloud_energy)
register("burst/mmpp-storm", burst_storm)
register("faults/hpc-outage", platform_outage)
register("ramp/overload", ramp_overload)
register("azure/minute-replay", azure_replay)
register("scale/million-burst", million_burst)
register("smoke/tiny", smoke_tiny)

# ---------------------------------------------------------------------------
# Flight-recorder A/B arms (the observability layer; not ported yet:
# running one raises, naming ROADMAP.md Queue 1 item 6): the outage,
# burst-storm and
# overload scenarios re-examined through latency decomposition — the
# report's latency_breakdown section attributes each arm's SLO violations
# to its dominant segment (queue growth under overload, cold starts after
# recovery, ingress batching under bursts).
# ---------------------------------------------------------------------------

register("trace/hpc-outage",
         lambda: platform_outage().replace(name="trace/hpc-outage",
                                           trace=True))
register("trace/burst-storm",
         lambda: burst_storm().replace(name="trace/burst-storm",
                                       trace=True))
register("trace/overload-ramp",
         lambda: ramp_overload().replace(name="trace/overload-ramp",
                                         trace=True))

# ---------------------------------------------------------------------------
# Live-telemetry arms (the observability layer's telemetry and alerts;
# not ported yet, Queue 1 item 6): the same stress
# scenarios watched *online* — multi-resolution rollups feed burn-rate
# SLO alerts and platform-health detectors, and the report gains an
# ``alerts`` section.  Burn windows are shrunk from the SRE production
# defaults (5m/1h, 1h/6h) to match these 2-minute horizons; the health
# thresholds are tuned so ``telemetry/smoke-quiet`` emits zero events
# (tests pin both directions).
# ---------------------------------------------------------------------------

TELEMETRY_DEFAULTS: Dict[str, object] = {
    "tiers_s": [1.0, 10.0, 60.0],
    "capacity": 512,
    "slo_target": 0.9,                 # 10% error budget
    "eval_tier": 0,                    # evaluate on the 1 s tier
    "rules": [
        {"name": "fast_burn", "short_s": 10.0, "long_s": 60.0,
         "burn": 8.0, "severity": "page"},
        {"name": "slow_burn", "short_s": 30.0, "long_s": 120.0,
         "burn": 3.0, "severity": "ticket"},
    ],
    "min_long_samples": 20,
    "z_threshold": 6.0,
    "k_consecutive": 3,
    "warmup_buckets": 8,
}


def _with_telemetry(sc: Scenario, name: str) -> Scenario:
    return sc.replace(name=name, telemetry=dict(TELEMETRY_DEFAULTS))


# ---------------------------------------------------------------------------
# Per-tenant QoS + overload resilience (repro_torch.core.qos): multi-class
# mixes through the unified admission gate — DRR queue draining vs plain
# FIFO, shed vs degrade vs spillover under an overload ramp, and a
# brownout arm where an energy cap degrades the batch class first.  The
# report gains a ``qos`` section (per-class/per-tenant stats, fairness
# shares, admission counters); benchmarks/bench_qos.py asserts the
# DRR-vs-FIFO A/B headline.
# ---------------------------------------------------------------------------

QOS_PAIR = ("cloud-cluster", "edge-cluster")

# three tenants, three classes: interactive traffic that must stay fast,
# a rampable standard stream, and throughput-oriented batch filler
QOS_SPEC_BASE: Dict[str, object] = {
    "weights": [8, 3, 1],
    "slo_multipliers": [0.5, 1.0, 4.0],
    "shed_queue_depth": 300,
    "shed_hard_factor": 2.0,
}


def _qos_mix(ramp_end_rps: float) -> tuple:
    return (
        Workload("nodeinfo", qos_class="latency_critical", tenant=1,
                 arrival={"kind": "poisson", "rps": 25.0}),
        Workload("sentiment-analysis", qos_class="standard", tenant=2,
                 arrival={"kind": "ramp", "start_rps": 5.0,
                          "end_rps": ramp_end_rps}),
        Workload("JSON-loads", qos_class="batch", tenant=3,
                 arrival={"kind": "poisson", "rps": 40.0}),
    )


def qos_overload(action: str, duration_s: float = 120.0) -> Scenario:
    """Shed / degrade / spillover A/B: the ``ramp/overload`` pressure
    pattern re-run with three tenants in three classes, identical except
    for the admission controller's overload action."""
    spec = dict(QOS_SPEC_BASE)
    spec["overload_action"] = action
    return Scenario(
        name=f"qos/overload-{action}",
        platforms=QOS_PAIR,
        workloads=_qos_mix(120.0),
        duration_s=duration_s,
        slo_overrides={"sentiment-analysis": 2.0},
        qos=spec)


def qos_burst_storm(drr: bool, duration_s: float = 120.0) -> Scenario:
    """DRR-vs-FIFO A/B under an MMPP burst storm: same three-class mix,
    same admission spec, but the FIFO arm runs uniform weights — which
    structurally disables the per-class queues (every enqueue stays on
    the single-FIFO fast path), so the only difference is drain order."""
    spec = dict(QOS_SPEC_BASE)
    spec.pop("shed_queue_depth")       # isolate drain order from shedding
    if not drr:
        spec["weights"] = [1, 1, 1]
    arm = "drr" if drr else "fifo"
    return Scenario(
        name=f"qos/burst-storm-{arm}",
        platforms=QOS_PAIR,
        workloads=(
            Workload("nodeinfo", qos_class="latency_critical", tenant=1,
                     arrival={"kind": "mmpp", "base_rps": 20.0,
                              "burst_rps": 150.0, "mean_quiet_s": 15.0,
                              "mean_burst_s": 3.0}),
            Workload("sentiment-analysis", qos_class="standard", tenant=2,
                     arrival={"kind": "poisson", "rps": 20.0}),
            Workload("JSON-loads", qos_class="batch", tenant=3,
                     arrival={"kind": "mmpp", "base_rps": 30.0,
                              "burst_rps": 300.0, "mean_quiet_s": 20.0,
                              "mean_burst_s": 3.0}),
        ),
        duration_s=duration_s,
        qos=spec)


def qos_brownout(duration_s: float = 120.0) -> Scenario:
    """Brownout: a fleet-power cap trips mid-ramp and the controller
    sheds the batch class first, keeping interactive tenants served
    while total watts stay bounded."""
    spec = dict(QOS_SPEC_BASE)
    spec.pop("shed_queue_depth")       # brownout is the only shedder here
    spec["energy_cap_w"] = 135.0
    return Scenario(
        name="qos/brownout-energy-cap",
        platforms=QOS_PAIR,
        workloads=_qos_mix(90.0),
        duration_s=duration_s,
        slo_overrides={"sentiment-analysis": 2.0},
        qos=spec)


for _action in ("shed", "degrade", "spillover"):
    register(f"qos/overload-{_action}",
             lambda a=_action: qos_overload(a))
register("qos/burst-storm-drr", lambda: qos_burst_storm(True))
register("qos/burst-storm-fifo", lambda: qos_burst_storm(False))
register("qos/brownout-energy-cap", qos_brownout)

register("telemetry/hpc-outage",
         lambda: _with_telemetry(platform_outage(),
                                 "telemetry/hpc-outage"))
register("telemetry/overload-ramp",
         lambda: _with_telemetry(ramp_overload(),
                                 "telemetry/overload-ramp"))
register("telemetry/burst-storm",
         lambda: _with_telemetry(burst_storm(),
                                 "telemetry/burst-storm"))
register("telemetry/smoke-quiet",
         lambda: _with_telemetry(smoke_tiny(), "telemetry/smoke-quiet"))

# ---------------------------------------------------------------------------
# Decision-provenance arms (the observability layer's provenance and
# what-if replay; not ported yet, Queue 1 item 6): the same
# scenarios with the decision journal attached — the report gains a
# ``decision_provenance`` section (perf-model calibration, filter kill
# counts, regret, churn) and ``run.py explain <arm> [--whatif ...]``
# renders kill-reason / counterfactual summaries over the journal.
# ---------------------------------------------------------------------------

register("prov/smoke-tiny",
         lambda: smoke_tiny().replace(name="prov/smoke-tiny",
                                      provenance=True))
register("prov/etl-pipeline",
         lambda: chain_etl().replace(name="prov/etl-pipeline",
                                     provenance=True))
register("prov/burst-storm-drr",
         lambda: qos_burst_storm(True).replace(name="prov/burst-storm-drr",
                                               provenance=True))
