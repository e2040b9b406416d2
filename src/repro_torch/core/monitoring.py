"""Monitoring (paper §3.1.2, Table 1): user-, platform- and infrastructure-
centric metrics, aggregated per sampling window (default 10 s, as in the
paper's evaluation).

The registry is the FDN's Prometheus stand-in: platforms push raw samples,
the window aggregator derives the Table-1 metric set, and the scheduler /
behavioral models / FDNInspector benchmarks all read from here.

Two series backends share one API:

  * ``WindowSeries``         — per-window Python lists (the original,
                               kept as the per-sample baseline);
  * ``ColumnarWindowSeries`` — samples buffered into flat NumPy columns,
                               per-window aggregation computed in one
                               vectorized flush when read.  The registry
                               defaults to this backend, so a 10^6-sample
                               run never appends to a Python list.

``MetricsRegistry.record_completions`` is the bulk completion path: it
ingests a whole ``ColumnarResultSink`` (arrival/end/platform/function/cold
columns) with one ``add_many`` per (platform, function, metric) group.
"""
from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.types import Invocation


def _interp_indices(n: int, q: float) -> Tuple[int, int, float]:
    """The one shared definition of linear-interpolated percentiles
    (numpy's default 'linear' method): the two order statistics bracketing
    rank ``q * (n - 1)`` and the interpolation fraction between them.
    Every percentile in the repo routes through here."""
    idx = q * (n - 1)
    lo = int(math.floor(idx))
    hi = min(lo + 1, n - 1)
    return lo, hi, idx - lo


def percentile(sorted_vals, q: float) -> float:
    """Linear-interpolated percentile over an ascending list OR ndarray."""
    n = len(sorted_vals)
    if n == 0:
        return float("nan")
    lo, hi, frac = _interp_indices(n, q)
    return float(sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac)


def percentile_unsorted(vals: np.ndarray, q: float) -> float:
    """``percentile`` without the O(n log n) sort: ``np.partition`` places
    just the two order statistics the interpolation needs."""
    vals = np.asarray(vals)
    n = vals.size
    if n == 0:
        return float("nan")
    lo, hi, frac = _interp_indices(n, q)
    part = np.partition(vals, (lo, hi))
    return float(part[lo] * (1 - frac) + part[hi] * frac)


class WindowSeries:
    """Per-window scalar aggregation: sum / last / values-for-percentiles."""

    def __init__(self, window_s: float):
        self.window_s = window_s
        self.sums: Dict[int, float] = defaultdict(float)
        self.counts: Dict[int, int] = defaultdict(int)
        self.values: Dict[int, List[float]] = defaultdict(list)

    def add(self, t: float, v: float):
        w = int(t // self.window_s)
        self.sums[w] += v
        self.counts[w] += 1
        self.values[w].append(v)

    def add_many(self, ts, vs):
        """Columnar ingest: fold parallel (t, v) arrays window-by-window
        (one dict update per touched window, not per sample)."""
        ts = np.asarray(ts, dtype=float)
        vs = np.asarray(vs, dtype=float)
        if ts.size == 0:
            return
        ws = (ts // self.window_s).astype(int)
        order = np.argsort(ws, kind="stable")
        ws, vs = ws[order], vs[order]
        bounds = np.flatnonzero(np.diff(ws)) + 1
        for chunk_w, chunk_v in zip(np.split(ws, bounds),
                                    np.split(vs, bounds)):
            w = int(chunk_w[0])
            self.sums[w] += float(chunk_v.sum())
            self.counts[w] += int(chunk_v.size)
            self.values[w].extend(chunk_v.tolist())

    def windows(self) -> List[int]:
        return sorted(self.sums)

    def series(self, agg: str = "sum") -> List[Tuple[float, float]]:
        out = []
        for w in self.windows():
            t = w * self.window_s
            if agg == "sum":
                out.append((t, self.sums[w]))
            elif agg == "mean":
                out.append((t, self.sums[w] / max(self.counts[w], 1)))
            elif agg == "p90":
                out.append((t, percentile_unsorted(
                    np.asarray(self.values[w]), 0.90)))
            elif agg == "count":
                out.append((t, float(self.counts[w])))
        return out

    def total(self) -> float:
        return sum(self.sums.values())

    def count(self) -> int:
        return sum(self.counts.values())

    def all_values(self) -> List[float]:
        out: List[float] = []
        for w in self.windows():
            out.extend(self.values[w])
        return out

    def values_array(self) -> np.ndarray:
        """All samples as one flat column (any order: percentile fodder)."""
        if not self.values:
            return np.empty(0)
        return np.concatenate([np.asarray(self.values[w])
                               for w in self.windows()])

    def p90(self) -> float:
        return percentile_unsorted(self.values_array(), 0.90)


class ColumnarWindowSeries:
    """``WindowSeries`` semantics over flat NumPy columns.

    Samples append into growable (t, v) arrays — scalar ``add`` costs one
    array store, ``add_many`` one slice copy — and the per-window
    aggregation (sums / counts / per-window value slices) is produced
    lazily by a single vectorized flush, cached until the next append.
    """

    __slots__ = ("window_s", "_t", "_v", "_n", "_agg")

    def __init__(self, window_s: float, capacity: int = 64):
        self.window_s = window_s
        self._t = np.empty(capacity)
        self._v = np.empty(capacity)
        self._n = 0
        self._agg = None

    # -------------------------------------------------------- ingest ---
    def _grow(self, need: int):
        cap = max(self._t.size * 2, need)
        for name in ("_t", "_v"):
            a = getattr(self, name)
            b = np.empty(cap, a.dtype)
            b[:self._n] = a[:self._n]
            setattr(self, name, b)

    def add(self, t: float, v: float):
        n = self._n
        if n == self._t.size:
            self._grow(n + 1)
        self._t[n] = t
        self._v[n] = v
        self._n = n + 1
        self._agg = None

    def add_many(self, ts, vs):
        ts = np.asarray(ts, dtype=float)
        vs = np.asarray(vs, dtype=float)
        if ts.size == 0:
            return
        need = self._n + ts.size
        if need > self._t.size:
            self._grow(need)
        self._t[self._n:need] = ts
        self._v[self._n:need] = vs
        self._n = need
        self._agg = None

    # --------------------------------------------------------- flush ---
    def _flush(self):
        """One vectorized group-by-window pass over the buffered columns:
        (window ids, per-window start offsets, counts, sums, values sorted
        by window with arrival order preserved inside a window)."""
        if self._agg is None:
            n = self._n
            if n == 0:
                e = np.empty(0)
                self._agg = (np.empty(0, np.int64), np.empty(0, np.int64),
                             np.empty(0, np.int64), e, e)
            else:
                w = (self._t[:n] // self.window_s).astype(np.int64)
                order = np.argsort(w, kind="stable")
                ws = w[order]
                vs = self._v[:n][order]
                uniq, starts = np.unique(ws, return_index=True)
                sums = np.add.reduceat(vs, starts)
                counts = np.diff(np.append(starts, n))
                self._agg = (uniq, starts, counts, sums, vs)
        return self._agg

    def windows(self) -> List[int]:
        return self._flush()[0].tolist()

    def series(self, agg: str = "sum") -> List[Tuple[float, float]]:
        uniq, starts, counts, sums, vs = self._flush()
        out = []
        for i, w in enumerate(uniq.tolist()):
            t = w * self.window_s
            if agg == "sum":
                out.append((t, float(sums[i])))
            elif agg == "mean":
                out.append((t, float(sums[i]) / max(int(counts[i]), 1)))
            elif agg == "p90":
                lo = int(starts[i])
                out.append((t, percentile_unsorted(
                    vs[lo:lo + int(counts[i])], 0.90)))
            elif agg == "count":
                out.append((t, float(counts[i])))
        return out

    def total(self) -> float:
        return float(self._v[:self._n].sum())

    def count(self) -> int:
        return self._n

    def all_values(self) -> List[float]:
        return self._flush()[4].tolist()

    def values_array(self) -> np.ndarray:
        return self._v[:self._n]

    def p90(self) -> float:
        return percentile_unsorted(self._v[:self._n], 0.90)


SeriesLike = Union[WindowSeries, ColumnarWindowSeries]


class MetricsRegistry:
    """Keyed by (platform, function, metric)."""

    USER = ("response_time", "requests")                      # user-centric
    PLATFORM = ("invocations", "cold_starts", "exec_time",    # platform-
                "replicas", "memory_mb")                      # centric
    INFRA = ("cpu_util", "mem_util", "disk_io")               # infra-centric
    # chain-centric (recorded under the "_chain" pseudo-platform, keyed by
    # chain label): end-to-end latency, bytes crossing platforms, seconds
    # spent moving them (the chains layer)
    CHAIN = ("chain_latency", "bytes_moved", "transfer_s")

    def __init__(self, window_s: float = 10.0, columnar: bool = True):
        self.window_s = window_s
        self._series_cls = ColumnarWindowSeries if columnar else WindowSeries
        self._m: Dict[Tuple[str, str, str], SeriesLike] = {}
        # When set, per-invocation ``record_completion`` becomes a no-op:
        # the caller owns a ColumnarResultSink and ingests it in bulk at
        # the end of the run via ``record_completions`` (FDNInspector's
        # 10^6-invocation scenarios never pay a per-sample hot path).
        self.defer_completions = False
        # Live telemetry subscription (the telemetry layer): every ingest
        # through add/add_many is mirrored to the engine's rollups.  One
        # ``is None`` check per call — same discipline as the recorder.
        self.telemetry = None

    def _get(self, platform: str, fn: str, metric: str) -> SeriesLike:
        key = (platform, fn, metric)
        if key not in self._m:
            self._m[key] = self._series_cls(self.window_s)
        return self._m[key]

    def add(self, platform: str, fn: str, metric: str, t: float, v: float):
        self._get(platform, fn, metric).add(t, v)
        tel = self.telemetry
        if tel is not None:
            tel.observe(platform, fn, metric, t, v)

    def add_many(self, platform: str, fn: str, metric: str, ts, vs):
        """Bulk sample ingest (columnar result sinks, batched replays)."""
        self._get(platform, fn, metric).add_many(ts, vs)
        tel = self.telemetry
        if tel is not None:
            tel.observe_many(platform, fn, metric, np.asarray(ts, float),
                             np.asarray(vs, float))

    def record_completion(self, inv: Invocation, visible_infra: bool = True):
        if self.defer_completions:
            return
        p, f, t = inv.platform or "?", inv.fn.name, inv.end_t or 0.0
        self.add(p, f, "requests", t, 1.0)
        self.add(p, f, "response_time", t, inv.response_time or 0.0)
        self.add(p, f, "invocations", t, 1.0)
        self.add(p, f, "exec_time", t, inv.exec_time)
        if inv.cold_start:
            self.add(p, f, "cold_starts", t, 1.0)
        self.add(p, f, "memory_mb", t, float(inv.fn.memory_mb))
        if visible_infra:
            self.add(p, f, "disk_io", t,
                     inv.fn.read_bytes + inv.fn.write_bytes)

    def record_completions(self, sink,
                           visible_infra: Union[bool, Dict[str, bool]]
                           = True):
        """Bulk completion ingest from a ``loadgen.ColumnarResultSink``:
        the Table-1 metric set of ``record_completion``, derived from the
        sink's flat columns with one ``add_many`` per (platform, function,
        metric) group — no per-sample Python work.

        ``visible_infra`` may be a bool or a per-platform dict (GCF-style
        platforms expose no infrastructure metrics)."""
        cols = sink.completion_columns()
        end, arrival = cols["end"], cols["arrival"]
        plat_col, fn_col = cols["platform"], cols["fn"]
        cold = cols["cold"]
        exec_col = cols["exec"]
        rt = end - arrival
        for pname, pid in cols["platform_ids"].items():
            pmask = plat_col == pid
            if not pmask.any():
                continue
            infra = (visible_infra.get(pname, True)
                     if isinstance(visible_infra, dict) else visible_infra)
            for fname, fid in cols["fn_ids"].items():
                mask = pmask & (fn_col == fid)
                n = int(np.count_nonzero(mask))
                if n == 0:
                    continue
                ts = end[mask]
                ones = np.ones(n)
                spec = cols["fn_specs"][fname]
                self.add_many(pname, fname, "requests", ts, ones)
                self.add_many(pname, fname, "response_time", ts, rt[mask])
                self.add_many(pname, fname, "invocations", ts, ones)
                self.add_many(pname, fname, "exec_time", ts, exec_col[mask])
                cmask = mask & cold
                if cmask.any():
                    self.add_many(pname, fname, "cold_starts", end[cmask],
                                  np.ones(int(cmask.sum())))
                self.add_many(pname, fname, "memory_mb", ts,
                              np.full(n, float(spec.memory_mb)))
                if infra:
                    self.add_many(pname, fname, "disk_io", ts,
                                  np.full(n, spec.read_bytes +
                                          spec.write_bytes))

    def series(self, platform: str, fn: str, metric: str,
               agg: str = "sum") -> List[Tuple[float, float]]:
        return self._get(platform, fn, metric).series(agg)

    def response_values(self, platform: str, fn: str = "*") -> np.ndarray:
        """All response-time samples for (platform, fn) as one column."""
        cols = [ws.values_array() for (p, f, m), ws in self._m.items()
                if m == "response_time" and p == platform
                and (fn == "*" or f == fn)]
        cols = [c for c in cols if c.size]
        if not cols:
            return np.empty(0)
        return cols[0] if len(cols) == 1 else np.concatenate(cols)

    def p90_response(self, platform: str, fn: str = "*") -> float:
        return percentile_unsorted(self.response_values(platform, fn), 0.90)

    def total(self, platform: str, fn: str, metric: str) -> float:
        return self._get(platform, fn, metric).total()

    def requests_served(self, platform: str, fn: str = "*") -> int:
        n = 0
        for (p, f, m), ws in self._m.items():
            if m == "requests" and p == platform and (fn == "*" or f == fn):
                n += int(ws.total())
        return n
