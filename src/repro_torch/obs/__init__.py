"""Observability (repro_torch.obs): the FDN's flight recorder.

The paper's FDN stands on monitoring (§3.1.2) — but windowed metrics say
*that* p90 blew the SLO, never *why*.  This package records per-invocation
lifecycle segments into struct-of-arrays span columns (``recorder``),
decomposes response time into exactly-reconciling segments and attributes
SLO violations to their dominant segment (``analysis``), and exports any
run as Chrome trace-event JSON openable in Perfetto (``export``).

Disabled, the recorder costs one ``is None`` check per admission burst;
enabled, deterministic head-based sampling keeps million-invocation runs
in budget.

The live half (``telemetry`` / ``alerts``) watches the system while it
runs: multi-resolution rollup tiers over the columnar metrics path,
multi-window burn-rate SLO alerting and EWMA+MAD platform-health
anomaly detection — same ``is None``-guard discipline, O(tiers) memory
on streams of any length.

``provenance`` / ``whatif`` answer *why this platform*: a columnar
decision journal tapped at the fused ``fn_decisions`` fast path records
per-candidate filter-kill bits, score columns, chosen slot and
runner-up margin; the journal joins to sink completions for
predicted-vs-realized calibration and decision regret, and replays
offline under alternate policies — same-policy replay reproduces the
original choices byte-identically.
"""
from repro_torch.obs.recorder import (
    ADMIT, CHAIN_STAGE, COLD_START, DATA, EXEC, HEDGE, INGRESS, KIND_NAMES,
    LIFECYCLE, POOL_PREWARM, POOL_RETIRE, PREWARM_START, QUEUE, REJECT,
    SEGMENT_NAMES, FlightRecorder, SpanBuffer)
from repro_torch.obs.analysis import (Decomposition, chain_critical_paths,
                                      decompose, latency_breakdown_section,
                                      reconcile, slo_attribution)
from repro_torch.obs.export import (alert_annotation_events,
                                    chrome_trace_events, to_openmetrics,
                                    write_chrome_trace)
from repro_torch.obs.telemetry import (TelemetryConfig, TelemetryEngine,
                                       TierRing, SeriesRollup)
from repro_torch.obs.alerts import (AlertConfig, BurnRule, alerts_section,
                                    evaluate_health, evaluate_slo_burn)
from repro_torch.obs.provenance import (DecisionJournal,
                                        decision_provenance_section,
                                        load_journal)
from repro_torch.obs.whatif import (ReplayResult, WhatIfConfig, replay,
                                    replay_matches, whatif_section)

__all__ = [
    "SpanBuffer", "FlightRecorder", "KIND_NAMES", "SEGMENT_NAMES",
    "LIFECYCLE", "INGRESS", "QUEUE", "COLD_START", "PREWARM_START", "DATA",
    "EXEC", "ADMIT", "REJECT", "HEDGE", "CHAIN_STAGE", "POOL_PREWARM",
    "POOL_RETIRE",
    "Decomposition", "decompose", "reconcile", "slo_attribution",
    "chain_critical_paths", "latency_breakdown_section",
    "chrome_trace_events", "write_chrome_trace", "alert_annotation_events",
    "TelemetryConfig", "TelemetryEngine", "TierRing", "SeriesRollup",
    "AlertConfig", "BurnRule", "alerts_section", "evaluate_health",
    "evaluate_slo_burn",
    "to_openmetrics",
    "DecisionJournal", "decision_provenance_section", "load_journal",
    "ReplayResult", "WhatIfConfig", "replay", "replay_matches",
    "whatif_section",
]
