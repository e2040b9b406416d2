"""Online alerting over telemetry rollups: multi-window multi-burn-rate
SLO alerts plus EWMA+MAD platform-health anomaly detection.

Both evaluators read *closed rollup buckets* from a
:class:`~repro_torch.obs.telemetry.TelemetryEngine` — never raw samples —
so their cost is O(live buckets) per evaluation and their output is a pure
function of the rollup state: the alert event log is byte-identical
across runs of the same seeded scenario.

SLO alerting follows the Google-SRE multi-window multi-burn-rate
recipe: a rule fires only when the error-budget burn rate exceeds its
threshold over BOTH a short window (fast detection) and a long window
(flapping suppression).  The classic production windows (14.4x over
5m+1h pages, 3x over 1h+6h tickets) are the defaults; registry
scenarios shrink them to match their 2-minute horizons.

Health detection runs an EWMA baseline per (platform, health-metric)
series with a median-absolute-deviation scale estimated from the
EWMA residuals; ``k_consecutive`` buckets beyond ``z_threshold`` robust
z-scores raise an anomaly.  The MAD scale has a relative floor so
flat-line series (constant watts on an idle platform) don't alarm on
float noise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.telemetry import HEALTH_METRICS, NO_FN, TelemetryEngine

__all__ = ["BurnRule", "AlertConfig", "evaluate_slo_burn",
           "evaluate_health", "alerts_section", "DEFAULT_RULES"]


@dataclass(frozen=True)
class BurnRule:
    """One multi-window burn-rate rule.  ``burn`` is the error-budget
    consumption multiple: burn 14.4 on a 99.9% SLO eats a 30-day budget
    in ~50 hours."""

    name: str
    short_s: float
    long_s: float
    burn: float
    severity: str          # "page" | "ticket"


# Google-SRE production defaults (5m/1h page at 14.4x, 1h/6h ticket at 3x)
DEFAULT_RULES: Tuple[BurnRule, ...] = (
    BurnRule("fast_burn", 300.0, 3600.0, 14.4, "page"),
    BurnRule("slow_burn", 3600.0, 21600.0, 3.0, "ticket"),
)


@dataclass(frozen=True)
class AlertConfig:
    """Evaluation knobs.  ``slo_target`` sets the error budget
    (budget = 1 - target); ``eval_tier`` picks which rollup tier the
    windows are measured on (window seconds are converted to bucket
    counts on that tier)."""

    slo_target: float = 0.99
    eval_tier: int = 0
    rules: Tuple[BurnRule, ...] = DEFAULT_RULES
    min_long_samples: int = 8        # long window needs this many samples
    # health detector
    ewma_alpha: float = 0.25
    z_threshold: float = 6.0
    k_consecutive: int = 3
    warmup_buckets: int = 8
    mad_floor_frac: float = 0.05     # scale floor as a fraction of |mean|

    @staticmethod
    def from_dict(d: Dict) -> "AlertConfig":
        keys = {f.name for f in
                AlertConfig.__dataclass_fields__.values()}  # type: ignore
        kw = {k: v for k, v in d.items() if k in keys}
        if "rules" in kw:
            kw["rules"] = tuple(
                r if isinstance(r, BurnRule) else BurnRule(**r)
                for r in kw["rules"])
        return AlertConfig(**kw)


def _dense_series(engine: TelemetryEngine, keys, tier: int):
    """Aggregate several (platform, fn, metric) series onto one dense
    bucket timeline: returns (ids, counts, sums, bad) with zero-filled
    gaps, or None when no key has data."""
    parts = []
    for key in keys:
        sr = engine.series.get(key)
        if sr is None:
            continue
        ids, counts, sums, _mins, _maxs, bad, _q = sr.series(tier)
        if len(ids):
            parts.append((ids, counts, sums, bad))
    if not parts:
        return None
    lo = min(int(p[0][0]) for p in parts)
    hi = max(int(p[0][-1]) for p in parts)
    n = hi - lo + 1
    counts = np.zeros(n, np.int64)
    sums = np.zeros(n)
    bad = np.zeros(n, np.int64)
    for ids, c, s, b in parts:
        idx = ids - lo
        np.add.at(counts, idx, c)
        np.add.at(sums, idx, s)
        np.add.at(bad, idx, b)
    return np.arange(lo, hi + 1, dtype=np.int64), counts, sums, bad


def _window_sums(x: np.ndarray, w: int) -> np.ndarray:
    """Trailing-window sums: out[i] = sum(x[max(0, i-w+1) .. i])."""
    c = np.cumsum(x, dtype=np.float64)
    out = c.copy()
    if w < len(x):
        out[w:] = c[w:] - c[:-w]
    return out


def evaluate_slo_burn(engine: TelemetryEngine, fns: Sequence[str],
                      cfg: AlertConfig) -> List[Dict]:
    """Burn-rate evaluation for each function's response_time series,
    aggregated across platforms.  Emits deterministic fire/resolve
    events ordered by (time, fn, rule)."""
    tier_s = engine.cfg.tiers_s[cfg.eval_tier]
    budget = max(1.0 - cfg.slo_target, 1e-9)
    platforms = sorted({p for (p, f, m) in engine.series
                        if m == "response_time"})
    events: List[Dict] = []
    for fn in sorted(fns):
        dense = _dense_series(
            engine, [(p, fn, "response_time") for p in platforms],
            cfg.eval_tier)
        if dense is None:
            continue
        ids, counts, _sums, bad = dense
        for rule in cfg.rules:
            ws = max(1, int(round(rule.short_s / tier_s)))
            wl = max(1, int(round(rule.long_s / tier_s)))
            tot_s = _window_sums(counts.astype(np.float64), ws)
            tot_l = _window_sums(counts.astype(np.float64), wl)
            bad_s = _window_sums(bad.astype(np.float64), ws)
            bad_l = _window_sums(bad.astype(np.float64), wl)
            burn_s = bad_s / np.maximum(tot_s, 1.0) / budget
            burn_l = bad_l / np.maximum(tot_l, 1.0) / budget
            # a window only counts once the timeline covers it — a 60 s
            # burn window evaluated 5 s into a run would alert on the
            # cold-start transient of an otherwise healthy scenario
            covered = np.arange(1, len(ids) + 1) >= wl
            active = (covered & (burn_s >= rule.burn)
                      & (burn_l >= rule.burn)
                      & (tot_l >= cfg.min_long_samples))
            prev = False
            for i in range(len(ids)):
                cur = bool(active[i])
                if cur != prev:
                    events.append({
                        "t": round(float((ids[i] + 1) * tier_s), 6),
                        "kind": "fire" if cur else "resolve",
                        "fn": fn,
                        "rule": rule.name,
                        "severity": rule.severity,
                        "burn_short": round(float(burn_s[i]), 6),
                        "burn_long": round(float(burn_l[i]), 6),
                    })
                prev = cur
    events.sort(key=lambda e: (e["t"], e["fn"], e["rule"], e["kind"]))
    return events


def _health_points(engine: TelemetryEngine, platform: str, metric: str,
                   tier: int):
    """Per-bucket mean series for one platform-health metric, or the
    derived cold-start rate (cold starts per completion)."""
    if metric == "cold_start_rate":
        fns = sorted({f for (p, f, m) in engine.series
                      if p == platform and m == "response_time"
                      and f != NO_FN})
        comp = _dense_series(
            engine, [(platform, f, "response_time") for f in fns], tier)
        if comp is None:
            return None
        ids, counts, _sums, _bad = comp
        cold = _dense_series(
            engine, [(platform, f, "cold_starts") for f in fns], tier)
        rate = np.zeros(len(ids))
        if cold is not None:
            cids, ccounts, csums, _cb = cold
            idx = cids - int(ids[0])
            ok = (idx >= 0) & (idx < len(ids))
            rate[idx[ok]] = csums[ok]
        return ids, rate / np.maximum(counts, 1)
    sr = engine.series.get((platform, NO_FN, metric))
    if sr is None:
        return None
    ids, counts, sums, _mins, _maxs, _bad, _q = sr.series(tier)
    if not len(ids):
        return None
    return ids, sums / np.maximum(counts, 1)


def evaluate_health(engine: TelemetryEngine, cfg: AlertConfig
                    ) -> List[Dict]:
    """EWMA+MAD robust z-score sweep over each platform's health series.
    Sequential over <= capacity points per series — cheap and exactly
    deterministic."""
    tier_s = engine.cfg.tiers_s[cfg.eval_tier]
    platforms = sorted({p for (p, f, m) in engine.series
                        if f == NO_FN and m in HEALTH_METRICS})
    events: List[Dict] = []
    metrics = list(HEALTH_METRICS) + ["cold_start_rate"]
    for platform in platforms:
        for metric in metrics:
            pts = _health_points(engine, platform, metric, cfg.eval_tier)
            if pts is None:
                continue
            ids, vals = pts
            mu = float(vals[0])
            resid: List[float] = []
            streak = 0
            active = False
            for i in range(1, len(vals)):
                x = float(vals[i])
                r = x - mu
                if len(resid) >= max(2, cfg.warmup_buckets):
                    mad = float(np.median(np.abs(np.asarray(resid))))
                    scale = max(1.4826 * mad,
                                cfg.mad_floor_frac * abs(mu), 1e-9)
                    z = max(-9999.0, min(9999.0, r / scale))
                    if abs(z) >= cfg.z_threshold:
                        streak += 1
                    else:
                        streak = 0
                        if active:
                            active = False
                            events.append({
                                "t": round(float((ids[i] + 1) * tier_s), 6),
                                "kind": "resolve",
                                "platform": platform,
                                "metric": metric,
                                "z": round(z, 4),
                            })
                    if streak >= cfg.k_consecutive and not active:
                        active = True
                        events.append({
                            "t": round(float((ids[i] + 1) * tier_s), 6),
                            "kind": "fire",
                            "platform": platform,
                            "metric": metric,
                            "z": round(z, 4),
                        })
                # anomalous points don't poison the baseline: only track
                # the EWMA/residuals while the detector is quiet
                if streak == 0:
                    resid.append(r)
                    if len(resid) > 4 * max(2, cfg.warmup_buckets):
                        resid.pop(0)
                    mu = mu + cfg.ewma_alpha * r
    events.sort(key=lambda e: (e["t"], e["platform"], e["metric"],
                               e["kind"]))
    return events


def alerts_section(engine: Optional[TelemetryEngine],
                   fns: Sequence[str],
                   cfg: Optional[AlertConfig] = None) -> Dict:
    """The canonical-JSON ``alerts`` ScenarioReport section."""
    if engine is None:
        return {"enabled": False}
    cfg = cfg or AlertConfig()
    engine.finalize()
    slo_events = evaluate_slo_burn(engine, fns, cfg)
    health_events = evaluate_health(engine, cfg)
    by_sev: Dict[str, int] = {}
    for e in slo_events:
        if e["kind"] == "fire":
            by_sev[e["severity"]] = by_sev.get(e["severity"], 0) + 1
    by_metric: Dict[str, int] = {}
    for e in health_events:
        if e["kind"] == "fire":
            by_metric[e["metric"]] = by_metric.get(e["metric"], 0) + 1
    return {
        "enabled": True,
        "config": {
            "slo_target": cfg.slo_target,
            "eval_tier_s": float(engine.cfg.tiers_s[cfg.eval_tier]),
            "rules": [{"name": r.name, "short_s": r.short_s,
                       "long_s": r.long_s, "burn": r.burn,
                       "severity": r.severity} for r in cfg.rules],
            "z_threshold": cfg.z_threshold,
            "k_consecutive": cfg.k_consecutive,
        },
        "rollup": engine.rollup_summary(),
        "slo": {"events": slo_events,
                "fires": sum(1 for e in slo_events if e["kind"] == "fire"),
                "by_severity": by_sev},
        "health": {"events": health_events,
                   "fires": sum(1 for e in health_events
                                if e["kind"] == "fire"),
                   "by_metric": by_metric},
    }
