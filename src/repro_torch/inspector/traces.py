"""FaaS trace library for open-loop replay (ROADMAP item; paper §4.3).

Every generator returns a flat NumPy array of arrival timestamps in
``[t0, t0 + duration_s)`` and is deterministic under its seed, so a trace
is a replayable artifact: the same spec always produces byte-identical
arrivals on any machine.

  * Azure-Functions-style traces: per-minute per-function invocation
    counts (the public Azure 2019 dataset format) expanded into arrival
    timestamps, plus a CSV loader for the real dataset.
  * Synthetic processes: diurnal (sinusoidal-rate Poisson via thinning),
    bursty MMPP (two-state Markov-modulated Poisson), linear ramp.
  * ``WorkloadMix``: interleaves per-function arrival streams into ONE
    sorted admission stream tagged by function index — the shape
    ``loadgen.run_arrival_mix`` consumes.

``build_arrivals`` dispatches a declarative spec dict (``{"kind": ...}``)
so FDNInspector scenarios can carry workloads as data.
"""
from __future__ import annotations

import csv
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.loadgen import (poisson_arrivals, trace_arrivals,
                                      uniform_arrivals)


# ---------------------------------------------------------------------------
# Azure Functions minute-count traces
# ---------------------------------------------------------------------------

def counts_to_arrivals(counts: Sequence[float], minute_s: float = 60.0,
                       seed: int = 0, t0: float = 0.0,
                       time_scale: float = 1.0) -> np.ndarray:
    """Expand per-minute invocation counts into arrival timestamps.

    Within minute m with count c, the c arrivals land uniformly at random
    (seeded) inside ``[m * minute_s, (m+1) * minute_s)`` — the standard
    open-loop replay of the Azure Functions 2019 dataset, which records
    counts, not timestamps.  ``time_scale`` dilates the replay (0.1 plays
    a day-long trace in 2.4 hours)."""
    counts = np.asarray(counts)
    rng = np.random.default_rng(seed)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0)
    minute_of = np.repeat(np.arange(counts.size), counts.astype(np.int64))
    offsets = rng.random(total)
    t = (minute_of + offsets) * minute_s
    t.sort(kind="stable")
    return t0 + t * time_scale


def load_azure_invocations_csv(path: str) -> Dict[str, np.ndarray]:
    """Load an Azure-Functions invocations-per-minute CSV.

    Format (the public ``invocations_per_function_md.anon`` schema):
    identifying columns (HashOwner/HashApp/HashFunction/Trigger) followed
    by one column per minute ("1", "2", ...).  Returns per-function
    minute-count arrays keyed by the function hash."""
    out: Dict[str, np.ndarray] = {}
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        minute_cols = [c for c in (reader.fieldnames or [])
                       if c.strip().isdigit()]
        minute_cols.sort(key=int)
        for row in reader:
            name = (row.get("HashFunction") or row.get("function")
                    or f"fn{len(out)}")
            counts = np.array([float(row[c] or 0) for c in minute_cols])
            out[name] = out[name] + counts if name in out else counts
    return out


def synthetic_azure_counts(functions: Sequence[str], minutes: int = 60,
                           mean_rpm: float = 60.0, seed: int = 0
                           ) -> Dict[str, np.ndarray]:
    """Deterministic stand-in for the public dataset: per-function
    per-minute Poisson counts shaped by a diurnal curve (the repo ships no
    real trace; tests and registry scenarios replay these)."""
    rng = np.random.default_rng(seed)
    phase = np.linspace(0.0, 2.0 * np.pi, minutes, endpoint=False)
    shape = 1.0 + 0.5 * np.sin(phase - np.pi / 2)
    return {name: rng.poisson(mean_rpm * shape * (0.5 + rng.random()))
            for name in functions}


# ---------------------------------------------------------------------------
# Synthetic arrival processes
# ---------------------------------------------------------------------------

def _thinned_poisson(rate_fn, rate_max: float, duration_s: float,
                     seed: int, t0: float) -> np.ndarray:
    """Inhomogeneous Poisson via thinning: draw at the envelope rate,
    accept each arrival with probability rate(t) / rate_max."""
    if rate_max <= 0 or duration_s <= 0:
        return np.empty(0)
    rng = np.random.default_rng(seed)
    n = max(int(rate_max * duration_s * 1.2) + 16, 16)
    gaps = rng.exponential(1.0 / rate_max, size=n)
    t = np.cumsum(gaps)
    while t[-1] < duration_s:
        more = rng.exponential(1.0 / rate_max, size=n)
        t = np.concatenate([t, t[-1] + np.cumsum(more)])
    t = t[t < duration_s]
    keep = rng.random(t.size) * rate_max < rate_fn(t)
    return t0 + t[keep]


def diurnal_arrivals(mean_rps: float, duration_s: float, seed: int = 0,
                     t0: float = 0.0, period_s: float = 86400.0,
                     peak_frac: float = 0.6) -> np.ndarray:
    """Sinusoidal daily cycle: rate(t) swings ``mean * (1 +/- peak_frac)``
    with the trough at t=0 (night) and the peak at half period (midday)."""
    peak_frac = min(max(peak_frac, 0.0), 1.0)

    def rate(t):
        return mean_rps * (1.0 + peak_frac *
                           np.sin(2.0 * np.pi * t / period_s - np.pi / 2))

    return _thinned_poisson(rate, mean_rps * (1.0 + peak_frac),
                            duration_s, seed, t0)


def mmpp_arrivals(base_rps: float, burst_rps: float, duration_s: float,
                  seed: int = 0, t0: float = 0.0,
                  mean_quiet_s: float = 20.0,
                  mean_burst_s: float = 5.0) -> np.ndarray:
    """Two-state Markov-modulated Poisson process: exponential-duration
    quiet/burst phases at ``base_rps`` / ``burst_rps`` — the classic bursty
    FaaS arrival model (burst storms against ``submit_batch``)."""
    if duration_s <= 0:
        return np.empty(0)
    rng = np.random.default_rng(seed)
    chunks: List[np.ndarray] = []
    t, burst = 0.0, False
    while t < duration_s:
        mean_len = mean_burst_s if burst else mean_quiet_s
        seg = min(float(rng.exponential(mean_len)), duration_s - t)
        rate = burst_rps if burst else base_rps
        if rate > 0 and seg > 0:
            n = rng.poisson(rate * seg)
            if n:
                chunks.append(t + np.sort(rng.random(n)) * seg)
        t += seg
        burst = not burst
    if not chunks:
        return np.empty(0)
    return t0 + np.concatenate(chunks)


def ramp_arrivals(start_rps: float, end_rps: float, duration_s: float,
                  seed: int = 0, t0: float = 0.0) -> np.ndarray:
    """Linear rate ramp (load staircase / overload probes)."""
    def rate(t):
        return start_rps + (end_rps - start_rps) * t / max(duration_s, 1e-9)

    return _thinned_poisson(rate, max(start_rps, end_rps), duration_s,
                            seed, t0)


# ---------------------------------------------------------------------------
# Declarative dispatch + multi-function mixes
# ---------------------------------------------------------------------------

ARRIVAL_KINDS = ("poisson", "uniform", "diurnal", "mmpp", "ramp", "trace",
                 "azure")


def build_arrivals(spec: Mapping, duration_s: float, seed: int = 0,
                   t0: float = 0.0) -> np.ndarray:
    """Materialize a declarative arrival spec: ``{"kind": ..., ...}``.

    ``duration_s``/``seed`` are scenario-level defaults a spec may
    override; everything else is kind-specific parameters."""
    kind = spec.get("kind", "poisson")
    duration_s = float(spec.get("duration_s", duration_s))
    seed = int(spec.get("seed", seed))
    if kind == "poisson":
        return poisson_arrivals(spec["rps"], duration_s, seed=seed, t0=t0)
    if kind == "uniform":
        return uniform_arrivals(spec["rps"], duration_s, t0=t0)
    if kind == "diurnal":
        return diurnal_arrivals(
            spec["mean_rps"], duration_s, seed=seed, t0=t0,
            period_s=float(spec.get("period_s", 86400.0)),
            peak_frac=float(spec.get("peak_frac", 0.6)))
    if kind == "mmpp":
        return mmpp_arrivals(
            spec["base_rps"], spec["burst_rps"], duration_s, seed=seed,
            t0=t0, mean_quiet_s=float(spec.get("mean_quiet_s", 20.0)),
            mean_burst_s=float(spec.get("mean_burst_s", 5.0)))
    if kind == "ramp":
        return ramp_arrivals(spec["start_rps"], spec["end_rps"],
                             duration_s, seed=seed, t0=t0)
    if kind == "trace":
        return trace_arrivals(spec["times"], t0=t0,
                              time_scale=float(spec.get("time_scale", 1.0)))
    if kind == "azure":
        return counts_to_arrivals(
            spec["counts"], minute_s=float(spec.get("minute_s", 60.0)),
            seed=seed, t0=t0,
            time_scale=float(spec.get("time_scale", 1.0)))
    raise KeyError(f"unknown arrival kind {kind!r} "
                   f"(expected one of {ARRIVAL_KINDS})")


class WorkloadMix:
    """Interleave per-function arrival streams into one admission stream.

    ``merge`` returns ``(times, fn_idx, names)``: the globally sorted
    timestamps, a parallel index into ``names`` per arrival, and the
    distinct function names in first-added order.  The sort is stable, so
    simultaneous arrivals keep stream-insertion order; per-function counts
    are preserved exactly.  Streams may be tagged with a QoS class and a
    tenant; ``merge_tagged`` additionally returns the per-arrival qos /
    tenant columns aligned with ``times``."""

    def __init__(self):
        self._streams: List[Tuple[str, np.ndarray, int, int]] = []

    def add(self, fn_name: str, arrivals: np.ndarray,
            qos: int = 1, tenant: int = 0) -> "WorkloadMix":
        self._streams.append((fn_name,
                              np.asarray(arrivals, dtype=float),
                              int(qos), int(tenant)))
        return self

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for name, arr, _q, _t in self._streams:
            out[name] = out.get(name, 0) + int(arr.size)
        return out

    @property
    def total(self) -> int:
        return sum(arr.size for _, arr, _q, _t in self._streams)

    def merge(self) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        times, idx, names, _qos, _tenant = self.merge_tagged()
        return times, idx, names

    def merge_tagged(self) -> Tuple[np.ndarray, np.ndarray, List[str],
                                    np.ndarray, np.ndarray]:
        names: List[str] = []
        ids: Dict[str, int] = {}
        times_parts: List[np.ndarray] = []
        idx_parts: List[np.ndarray] = []
        qos_parts: List[np.ndarray] = []
        ten_parts: List[np.ndarray] = []
        for name, arr, q, t in self._streams:
            fid = ids.get(name)
            if fid is None:
                fid = len(names)
                ids[name] = fid
                names.append(name)
            times_parts.append(arr)
            idx_parts.append(np.full(arr.size, fid, np.int64))
            qos_parts.append(np.full(arr.size, q, np.int8))
            ten_parts.append(np.full(arr.size, t, np.int32))
        if not times_parts:
            return (np.empty(0), np.empty(0, np.int64), names,
                    np.empty(0, np.int8), np.empty(0, np.int32))
        times = np.concatenate(times_parts)
        idx = np.concatenate(idx_parts)
        qos = np.concatenate(qos_parts)
        tenant = np.concatenate(ten_parts)
        order = np.argsort(times, kind="stable")
        return (times[order], idx[order], names,
                qos[order], tenant[order])
