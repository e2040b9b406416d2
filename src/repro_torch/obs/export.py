"""Chrome trace-event export: open any traced run in Perfetto.

``write_chrome_trace`` serializes the recorder's span columns as the
Chrome trace-event JSON format (``{"traceEvents": [...]}``, complete
``"X"`` events with microsecond ``ts``/``dur``).  Platforms map to
processes and invocations to tracks, so a scenario's queue waits, cold
starts, data staging and executions line up visually per platform —
load ``chrome://tracing`` or https://ui.perfetto.dev and drop the file.

``alert_annotation_events`` overlays the live-telemetry alert log
(repro_torch.obs.alerts) as instant events: SLO burn alerts land on the
control track (pid 0, they aggregate across platforms) and platform
health anomalies on their platform's track, so a queue-depth anomaly
lines up with the queue spans that caused it.

``to_openmetrics`` renders a ``TelemetryEngine``'s rollups as an
OpenMetrics text exposition — the lingua franca of Prometheus scrapes —
so any run's telemetry can feed an external dashboard without bespoke
glue.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.recorder import KIND_NAMES, LIFECYCLE, FlightRecorder


def alert_annotation_events(slo_events: Sequence[Dict[str, Any]],
                            health_events: Sequence[Dict[str, Any]],
                            pnames: Sequence[str]
                            ) -> List[Dict[str, Any]]:
    """Alert log entries as Chrome instant events ("i", process scope).

    ``pnames`` is the recorder's platform order — the same pid mapping
    (platform index + 1) the span events use; health events for
    platforms the recorder never saw fall back to the control track."""
    pid_of = {name: i + 1 for i, name in enumerate(pnames)}
    events: List[Dict[str, Any]] = []
    for e in slo_events:
        events.append({
            "name": f"slo:{e['rule']}:{e['kind']}",
            "ph": "i", "s": "p",
            "ts": float(e["t"]) * 1e6,
            "pid": 0, "tid": 0,
            "cat": "alert",
            "args": {"fn": e["fn"], "severity": e["severity"],
                     "burn_short": e["burn_short"],
                     "burn_long": e["burn_long"]},
        })
    for e in health_events:
        events.append({
            "name": f"health:{e['metric']}:{e['kind']}",
            "ph": "i", "s": "p",
            "ts": float(e["t"]) * 1e6,
            "pid": pid_of.get(e["platform"], 0), "tid": 0,
            "cat": "alert",
            "args": {"platform": e["platform"], "z": e["z"]},
        })
    return events


def chrome_trace_events(rec: FlightRecorder) -> List[Dict[str, Any]]:
    events: List[Dict[str, Any]] = []
    pnames = rec.platform_names()
    fnames = rec.fn_names()
    events.append({"name": "process_name", "ph": "M", "pid": 0,
                   "args": {"name": "(control)"}})
    for pid, pname in enumerate(pnames):
        events.append({"name": "process_name", "ph": "M", "pid": pid + 1,
                       "args": {"name": pname}})
    cols = rec.spans.columns()
    inv = cols["inv"]
    kind = cols["kind"]
    t0 = cols["t0"]
    t1 = cols["t1"]
    plat = cols["platform"]
    fn = cols["fn"]
    link = cols["link"]
    for i in range(inv.size):
        k = int(kind[i])
        fid = int(fn[i])
        events.append({
            "name": KIND_NAMES[k],
            "ph": "X",
            "ts": float(t0[i]) * 1e6,
            "dur": (float(t1[i]) - float(t0[i])) * 1e6,
            "pid": int(plat[i]) + 1,
            "tid": int(inv[i]) if inv[i] >= 0 else 0,
            "cat": "lifecycle" if k < LIFECYCLE else "control",
            "args": {"fn": fnames[fid] if 0 <= fid < len(fnames) else "",
                     "link": int(link[i])},
        })
    return events


def write_chrome_trace(rec: FlightRecorder, path: str,
                       alerts: Optional[Dict[str, Any]] = None) -> int:
    """Write the trace file; returns the number of events written.

    ``alerts`` is a ScenarioReport ``alerts`` section: its SLO and
    health event logs become instant-event annotations on the matching
    tracks."""
    events = chrome_trace_events(rec)
    if alerts and alerts.get("enabled"):
        events += alert_annotation_events(
            alerts.get("slo", {}).get("events", []),
            alerts.get("health", {}).get("events", []),
            rec.platform_names())
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


# ---------------------------------------------------------------------------
# OpenMetrics text exposition


_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _om_name(metric: str) -> str:
    return "fdn_" + _NAME_BAD.sub("_", metric)


def _om_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _om_float(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    # repr round-trips float64 exactly, so a parse-back compares equal
    return repr(float(v))


def to_openmetrics(engine, tier: Optional[int] = None) -> str:
    """Render a ``TelemetryEngine``'s rollups as OpenMetrics text.

    Each (platform, fn, metric) series aggregates its live buckets of
    one tier — by default the coarsest, which after ``finalize`` covers
    the whole run horizon — into one summary family ``fdn_<metric>``
    (``_count``/``_sum`` plus the sketch quantile of the newest live
    bucket), min/max gauges and an SLO-violation ``_bad`` counter.
    Engine totals ride along as ``fdn_telemetry_*``.  Floats are
    ``repr``-formatted so a parse-back compares exactly equal."""
    if tier is None:
        tier = len(engine.cfg.tiers_s) - 1
    q_label = _om_float(float(engine.cfg.quantile))
    # (metric -> [(labels, count, sum, min, max, bad, quantile)])
    per_metric: Dict[str, List] = {}
    for (platform, fn, metric) in engine.keys():
        sr = engine.series[(platform, fn, metric)]
        ids, counts, sums, mins, maxs, bad, q = sr.series(tier)
        if len(ids) == 0:
            continue
        labels = (f'platform="{_om_label(platform)}",'
                  f'fn="{_om_label(fn)}"')
        per_metric.setdefault(metric, []).append(
            (labels, int(counts.sum()), float(sums.sum()),
             float(mins.min()), float(maxs.max()), int(bad.sum()),
             float(q[-1])))
    out: List[str] = []
    for metric in sorted(per_metric):
        name = _om_name(metric)
        rows = per_metric[metric]
        out.append(f"# TYPE {name} summary")
        out.append(f"# HELP {name} rollup of the {metric} series "
                   f"(tier {tier})")
        for labels, cnt, tot, _lo, _hi, _bad, qv in rows:
            out.append(f"{name}_count{{{labels}}} {cnt}")
            out.append(f"{name}_sum{{{labels}}} {_om_float(tot)}")
            out.append(f"{name}{{{labels},quantile=\"{q_label}\"}} "
                       f"{_om_float(qv)}")
        out.append(f"# TYPE {name}_min gauge")
        for labels, _cnt, _tot, lo, _hi, _bad, _qv in rows:
            out.append(f"{name}_min{{{labels}}} {_om_float(lo)}")
        out.append(f"# TYPE {name}_max gauge")
        for labels, _cnt, _tot, _lo, hi, _bad, _qv in rows:
            out.append(f"{name}_max{{{labels}}} {_om_float(hi)}")
        out.append(f"# TYPE {name}_bad counter")
        out.append(f"# HELP {name}_bad samples above the series' "
                   f"violation threshold")
        for labels, _cnt, _tot, _lo, _hi, nbad, _qv in rows:
            out.append(f"{name}_bad_total{{{labels}}} {nbad}")
    out.append("# TYPE fdn_telemetry_samples counter")
    out.append(f"fdn_telemetry_samples_total {int(engine.folded)}")
    out.append("# TYPE fdn_telemetry_flushes counter")
    out.append(f"fdn_telemetry_flushes_total {int(engine.flushes)}")
    out.append("# TYPE fdn_telemetry_dropped_late counter")
    out.append(f"fdn_telemetry_dropped_late_total "
               f"{int(engine.dropped_late())}")
    out.append("# TYPE fdn_telemetry_series gauge")
    out.append(f"fdn_telemetry_series {len(engine.series)}")
    out.append("# EOF")
    return "\n".join(out) + "\n"
