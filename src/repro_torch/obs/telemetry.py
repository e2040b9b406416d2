"""Live telemetry engine: multi-resolution rollups over the columnar
metrics path.

The FDN's monitoring loop (paper §3.1.2) continuously scrapes
per-platform metrics; the flight recorder (``obs.recorder``) answers *why*
a run was slow after the fact, but nothing watches the system *while it
runs*.
This module is the online half: a :class:`TelemetryEngine` subscribes to
every ``MetricsRegistry`` ingest site (one ``is None`` check per burst,
same discipline as the flight recorder) and folds each
(platform, fn, metric) sample stream into ring-buffered, grow-free
multi-resolution tiers — 1s/10s/60s by default — holding exact
sum/count/min/max plus a mergeable P² quantile sketch per bucket
(reusing the perf model's ``QuantileState`` discipline from
``core.behavioral``).

Memory is O(tiers x capacity) regardless of stream length: a 14-day
streaming replay keeps the same footprint as a 60-second smoke run.
Two structural invariants make the state exactly reproducible:

* **cascade merging** — raw samples fold only into the *finest* tier;
  every coarser tier is produced by merging closed finer buckets upward
  (``child_id // ratio``).  Folding through 1s and merging to 60s is
  therefore *identical* (not just close) to folding straight into 60s
  for sum/count/min/max, which the tier-consistency property test pins.
* **deterministic sketch feeds** — each closed bucket contributes at
  most ``sketch_samples`` evenly-strided time-ordered samples to its
  tier sketch, and merges feed marker heights in a fixed order, so the
  quantile state is a pure function of the input stream.

``alerts.py`` consumes the rollups: burn-rate SLO windows and platform
health detectors both read closed buckets, never raw samples.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.behavioral import QuantileState, _p2_update, _q_value

__all__ = ["TelemetryConfig", "TierRing", "SeriesRollup", "TelemetryEngine",
           "HEALTH_METRICS"]

# Platform-health series recorded by the control-plane taps (per-platform,
# fn slot "-"): queue depth in rows, busy-replica utilization 0..1, and
# instantaneous watts from the energy meter.  cold_start_rate is derived
# at alert-evaluation time from the cold_starts / response_time rollups.
HEALTH_METRICS = ("queue_depth", "utilization", "watts")

# fn-slot placeholder for per-platform (fn-less) health series
NO_FN = "-"


def _q_add_many(qs: QuantileState, slot: int, xs, q: float) -> None:
    """Feed a whole bucket's samples into one P² cell with a single
    load/store of the marker state.  Bit-identical to looping
    ``behavioral._q_add`` (the cells round-trip through float64, which
    is lossless) but ~10x cheaper per sample — the per-call array
    round-trip dominated streaming-replay folds."""
    c = int(qs.count[slot, 0])
    n = len(xs)
    if n == 0:
        return
    qs.count[slot, 0] = c + n
    i = 0
    while c < 5 and i < n:
        qs.buf[slot, 0, c] = xs[i]
        c += 1
        i += 1
        if c == 5:
            s = sorted(float(v) for v in qs.buf[slot, 0])
            qs.heights[slot, 0] = s
            qs.pos[slot, 0] = (0, 1, 2, 3, 4)
            qs.want[slot, 0] = (0, 2 * q, 4 * q, 2 + 2 * q, 4)
    if i >= n:
        return
    h = [float(v) for v in qs.heights[slot, 0]]
    pos = [int(v) for v in qs.pos[slot, 0]]
    want = [float(v) for v in qs.want[slot, 0]]
    while i < n:
        _p2_update(h, pos, want, q, float(xs[i]))
        i += 1
    qs.heights[slot, 0] = h
    qs.pos[slot, 0] = pos
    qs.want[slot, 0] = want


def _q_add_block(qs: QuantileState, slots: np.ndarray, X: np.ndarray,
                 L: np.ndarray, q: float) -> None:
    """Feed MANY P² cells at once: lane ``b`` consumes ``X[b, :L[b]]``
    into cell ``slots[b]``.  Cells are independent, so the inherently
    sequential per-sample marker update runs as a loop over sample
    *columns*, each step vectorized across lanes — the expression order
    inside a lane mirrors ``_p2_update`` exactly (same float64 IEEE ops),
    so results are bit-identical to looping ``_q_add_many`` per lane.
    ``slots`` must be distinct (one bucket per lane)."""
    B = len(slots)
    if B == 0:
        return
    K = int(X.shape[1])
    c = qs.count[slots, 0].copy()
    qs.count[slots, 0] = c + L
    buf = qs.buf[slots, 0]           # fancy indexing: working copies
    h = qs.heights[slots, 0]
    pos = qs.pos[slots, 0]
    want = qs.want[slots, 0]
    want_add = np.array([0.0, q / 2, q, (1 + q) / 2, 1.0])
    want_init = np.array([0.0, 2 * q, 4 * q, 2 + 2 * q, 4.0])
    with np.errstate(divide="ignore", invalid="ignore"):
        for j in range(K):
            act = j < L
            if not act.any():
                break
            x = X[:, j]
            pre_post = c >= 5
            # bootstrap lanes: fill buf; sort into markers at the 5th
            bl = np.flatnonzero(act & ~pre_post)
            if len(bl):
                buf[bl, c[bl]] = x[bl]
                c[bl] += 1
                done = bl[c[bl] == 5]
                if len(done):
                    h[done] = np.sort(buf[done], axis=1)
                    pos[done] = np.arange(5)
                    want[done] = want_init
            # post-bootstrap lanes: one vectorized _p2_update step
            p = np.flatnonzero(act & pre_post)
            if not len(p):
                continue
            hp5, np5, ns5 = h[p], pos[p], want[p]
            xv = x[p]
            lo = xv < hp5[:, 0]
            hi = xv >= hp5[:, 4]
            hp5[lo, 0] = xv[lo]
            hp5[hi, 4] = xv[hi]
            # k = the marker interval holding x (heights stay sorted, so
            # counting h[i] <= x over i in 0..3 matches the scalar scan)
            k = np.where(lo, 0, np.where(
                hi, 3, np.sum(hp5[:, :4] <= xv[:, None], axis=1) - 1))
            np5 += np.arange(5)[None, :] > k[:, None]
            ns5 += want_add
            for i in (1, 2, 3):
                d = ns5[:, i] - np5[:, i]
                gp = np5[:, i + 1] - np5[:, i]
                gm = np5[:, i - 1] - np5[:, i]
                move = ((d >= 1) & (gp > 1)) | ((d <= -1) & (gm < -1))
                ds = np.where(d > 0, 1, -1)
                # parabolic, mirroring the scalar expression order
                hpar = hp5[:, i] + ds / (np5[:, i + 1] - np5[:, i - 1]) * (
                    (np5[:, i] - np5[:, i - 1] + ds)
                    * (hp5[:, i + 1] - hp5[:, i]) / gp
                    + (np5[:, i + 1] - np5[:, i] - ds)
                    * (hp5[:, i] - hp5[:, i - 1]) / (-gm))
                h_adj = np.where(ds > 0, hp5[:, i + 1], hp5[:, i - 1])
                n_adj = np.where(ds > 0, np5[:, i + 1], np5[:, i - 1])
                hlin = hp5[:, i] + ds * (h_adj - hp5[:, i]) \
                    / (n_adj - np5[:, i])
                use_lin = ~((hp5[:, i - 1] < hpar) & (hpar < hp5[:, i + 1]))
                hnew = np.where(use_lin, hlin, hpar)
                hp5[:, i] = np.where(move, hnew, hp5[:, i])
                np5[:, i] += np.where(move, ds, 0)
            h[p], pos[p], want[p] = hp5, np5, ns5
    qs.buf[slots, 0] = buf
    qs.heights[slots, 0] = h
    qs.pos[slots, 0] = pos
    qs.want[slots, 0] = want


@dataclass(frozen=True)
class TelemetryConfig:
    """Engine knobs.  ``tiers_s`` must be ascending and each coarser tier
    an integer multiple of the previous (cascade merging requires aligned
    bucket boundaries)."""

    tiers_s: Tuple[float, ...] = (1.0, 10.0, 60.0)
    capacity: int = 512                # ring slots per tier
    quantile: float = 0.9              # sketch target quantile
    sketch_samples: int = 16           # max raw feeds per closed bucket
    auto_flush_samples: Optional[int] = 1 << 18   # None = manual flush
    metrics: Tuple[str, ...] = ("response_time", "cold_starts")

    def __post_init__(self):
        tiers = tuple(float(t) for t in self.tiers_s)
        if not tiers or any(t <= 0 for t in tiers):
            raise ValueError(f"bad tiers_s: {self.tiers_s}")
        for a, b in zip(tiers, tiers[1:]):
            ratio = b / a
            if ratio < 2 or abs(ratio - round(ratio)) > 1e-9:
                raise ValueError(
                    f"tier {b}s must be an integer multiple of {a}s")
        object.__setattr__(self, "tiers_s", tiers)
        object.__setattr__(self, "metrics", tuple(self.metrics))

    @staticmethod
    def from_dict(d: Dict) -> "TelemetryConfig":
        keys = {f.name for f in
                TelemetryConfig.__dataclass_fields__.values()}  # type: ignore
        kw = {k: v for k, v in d.items() if k in keys}
        if "tiers_s" in kw:
            kw["tiers_s"] = tuple(kw["tiers_s"])
        if "metrics" in kw:
            kw["metrics"] = tuple(kw["metrics"])
        return TelemetryConfig(**kw)


class TierRing:
    """One resolution tier of one series: a fixed-capacity ring of
    bucket aggregates keyed by absolute bucket id (``floor(t / bucket_s)``).

    Slots are addressed ``id % capacity``; an incoming id evicts whatever
    older bucket occupied its slot (the ring keeps the most recent
    ``capacity`` buckets of *timeline*, not of data).  ``bad`` counts
    samples above the series' violation threshold — the SLO burn-rate
    numerator — and rides the same reduceat pass as the other aggregates.
    """

    __slots__ = ("bucket_s", "cap", "ids", "counts", "sums", "mins",
                 "maxs", "bad", "sketch", "newest", "merged_upto",
                 "dropped_late", "quantile")

    def __init__(self, bucket_s: float, capacity: int, quantile: float):
        self.bucket_s = float(bucket_s)
        self.cap = int(capacity)
        self.quantile = float(quantile)
        self.ids = np.full(self.cap, -1, np.int64)
        self.counts = np.zeros(self.cap, np.int64)
        self.sums = np.zeros(self.cap)
        self.mins = np.zeros(self.cap)
        self.maxs = np.zeros(self.cap)
        self.bad = np.zeros(self.cap, np.int64)
        # one P² estimator per ring slot: (cap, 1) grid, cell (slot, 0)
        self.sketch = QuantileState.alloc(self.cap, 1)
        self.newest = -1          # largest bucket id ever opened
        self.merged_upto = 0      # ids < this were cascaded to the parent
        self.dropped_late = 0     # samples for already-cascaded buckets

    # -- slot lifecycle -----------------------------------------------

    def _reset_slot(self, slot: int, bid: int) -> None:
        self.ids[slot] = bid
        self.counts[slot] = 0
        self.sums[slot] = 0.0
        self.mins[slot] = np.inf
        self.maxs[slot] = -np.inf
        self.bad[slot] = 0
        self.sketch.count[slot, 0] = 0

    def slot_for(self, bid: int) -> int:
        """Return the (possibly freshly reset) slot for bucket ``bid``,
        or -1 when the bucket is too old to accept data."""
        if bid < self.merged_upto or bid <= self.newest - self.cap:
            self.dropped_late += 1
            return -1
        slot = bid % self.cap
        if self.ids[slot] != bid:
            self._reset_slot(slot, bid)
        if bid > self.newest:
            self.newest = bid
        return slot

    # -- accumulation -------------------------------------------------

    def accumulate(self, bid: int, count: int, total: float, lo: float,
                   hi: float, bad: int, q_feed: Iterable[float]) -> bool:
        slot = self.slot_for(bid)
        if slot < 0:
            return False
        self.counts[slot] += count
        self.sums[slot] += total
        if lo < self.mins[slot]:
            self.mins[slot] = lo
        if hi > self.maxs[slot]:
            self.maxs[slot] = hi
        self.bad[slot] += bad
        _q_add_many(self.sketch, slot, q_feed, self.quantile)
        return True

    def accumulate_block(self, bids: np.ndarray, counts: np.ndarray,
                         totals: np.ndarray, los: np.ndarray,
                         his: np.ndarray, bads: np.ndarray,
                         X: np.ndarray, L: np.ndarray,
                         drop_weights: Optional[np.ndarray] = None,
                         sum_chunks: Optional[np.ndarray] = None,
                         chunk_len: Optional[np.ndarray] = None) -> None:
        """Vectorized ``accumulate`` over a batch of DISTINCT ascending
        bucket ids spanning less than ``cap`` (so no lane evicts
        another's slot mid-batch).  ``drop_weights`` is what each dropped
        bucket adds to ``dropped_late`` (the cascade passes its per-
        parent child counts so the counter matches the scalar path).
        ``sum_chunks``/``chunk_len`` carry the unreduced per-child sums:
        adding them left-to-right keeps the float association of the
        one-at-a-time path, so merged sums stay bit-identical."""
        keep = ~((bids < self.merged_upto)
                 | (bids <= self.newest - self.cap))
        if not keep.all():
            d = ~keep
            self.dropped_late += int(d.sum() if drop_weights is None
                                     else drop_weights[d].sum())
            bids, counts, totals = bids[keep], counts[keep], totals[keep]
            los, his, bads = los[keep], his[keep], bads[keep]
            X, L = X[keep], L[keep]
            if sum_chunks is not None:
                sum_chunks, chunk_len = sum_chunks[keep], chunk_len[keep]
            if len(bids) == 0:
                return
        slots = bids % self.cap
        stale = self.ids[slots] != bids
        if stale.any():
            s = slots[stale]
            self.ids[s] = bids[stale]
            self.counts[s] = 0
            self.sums[s] = 0.0
            self.mins[s] = np.inf
            self.maxs[s] = -np.inf
            self.bad[s] = 0
            self.sketch.count[s, 0] = 0
        if bids[-1] > self.newest:
            self.newest = int(bids[-1])
        self.counts[slots] += counts
        if sum_chunks is None:
            self.sums[slots] += totals
        else:
            for g in range(sum_chunks.shape[1]):
                m = chunk_len > g
                if not m.any():
                    break
                self.sums[slots[m]] += sum_chunks[m, g]
        self.mins[slots] = np.minimum(self.mins[slots], los)
        self.maxs[slots] = np.maximum(self.maxs[slots], his)
        self.bad[slots] += bads
        _q_add_block(self.sketch, slots, X, L, self.quantile)

    # -- reads --------------------------------------------------------

    def live_order(self) -> np.ndarray:
        """Slots holding buckets still on the ring timeline, ascending
        by bucket id."""
        m = np.flatnonzero(self.ids > self.newest - self.cap)
        m = m[self.ids[m] >= 0]
        return m[np.argsort(self.ids[m], kind="stable")]

    def quantile_value(self, slot: int) -> float:
        return _q_value(self.sketch, int(slot), 0, self.quantile)

    def sketch_feed(self, slot: int) -> List[float]:
        """Deterministic upward-merge feed for one closed bucket: the
        exact bootstrap values while the cell is in bootstrap, else each
        marker height repeated in proportion to the observation count
        (capped so a merge costs O(1))."""
        s = int(slot)
        c = int(self.sketch.count[s, 0])
        if c == 0:
            return []
        if c < 5:
            return sorted(float(v) for v in self.sketch.buf[s, 0, :c])
        reps = max(1, min(c // 5, 8))
        out: List[float] = []
        for h in self.sketch.heights[s, 0]:
            out.extend([float(h)] * reps)
        return out


class SeriesRollup:
    """All tiers of one (platform, fn, metric) series plus its pending
    sample buffer.  Raw samples land in ``pend_*``; ``fold`` drains them
    into the finest tier and cascades closed buckets upward."""

    __slots__ = ("tiers", "thr", "pend_t", "pend_v", "pend_n")

    def __init__(self, cfg: TelemetryConfig, thr: float = np.inf):
        self.tiers = [TierRing(b, cfg.capacity, cfg.quantile)
                      for b in cfg.tiers_s]
        self.thr = float(thr)          # violation threshold (SLO numerator)
        self.pend_t = np.empty(1024)
        self.pend_v = np.empty(1024)
        self.pend_n = 0

    # -- ingest -------------------------------------------------------

    def add(self, t: float, v: float) -> None:
        n = self.pend_n
        if n == len(self.pend_t):
            self._grow(n + 1)
        self.pend_t[n] = t
        self.pend_v[n] = v
        self.pend_n = n + 1

    def add_many(self, ts: np.ndarray, vs: np.ndarray) -> None:
        k = len(ts)
        if k == 0:
            return
        n = self.pend_n
        if n + k > len(self.pend_t):
            self._grow(n + k)
        self.pend_t[n:n + k] = ts
        self.pend_v[n:n + k] = vs
        self.pend_n = n + k

    def _grow(self, need: int) -> None:
        cap = len(self.pend_t)
        while cap < need:
            cap *= 2
        for name in ("pend_t", "pend_v"):
            old = getattr(self, name)
            new = np.empty(cap)
            new[:self.pend_n] = old[:self.pend_n]
            setattr(self, name, new)

    # -- fold + cascade -----------------------------------------------

    def fold(self, sketch_samples: int) -> int:
        """Drain pending samples into the finest tier, then cascade every
        newly-closed bucket up the tier chain.  Returns samples folded."""
        n = self.pend_n
        if n == 0:
            return 0
        ts = self.pend_t[:n]
        vs = self.pend_v[:n]
        t0 = self.tiers[0]
        bids = np.floor_divide(ts, t0.bucket_s).astype(np.int64)
        order = np.argsort(bids, kind="stable")
        bids = bids[order]
        vs_s = vs[order]
        uniq, starts = np.unique(bids, return_index=True)
        ends = np.append(starts[1:], n)
        sums = np.add.reduceat(vs_s, starts)
        mins = np.minimum.reduceat(vs_s, starts)
        maxs = np.maximum.reduceat(vs_s, starts)
        if np.isfinite(self.thr):
            bads = np.add.reduceat(
                (vs_s > self.thr).astype(np.int64), starts)
        else:
            bads = np.zeros(len(uniq), np.int64)
        # span-grouping: one batch may cover more timeline than the ring
        # holds (a 1h streaming chunk vs a 512 x 1s ring).  Cascade after
        # every <capacity span of bucket ids so no bucket is slot-evicted
        # before its aggregates reached the parent tier.
        counts = ends - starts
        # feed index matrix, replicating np.linspace(a, b-1, m) exactly
        # (m = min(count, sketch_samples)): arange * step + start, with
        # the endpoint pinned — raw runs (m == count) degenerate to
        # consecutive indices, so one formula covers both cases
        k = sketch_samples
        m = np.minimum(counts, k)
        a = starts.astype(np.float64)
        bm1 = (ends - 1).astype(np.float64)
        step = np.where(m > 1, (bm1 - a) / np.maximum(m - 1, 1), 0.0)
        idx = a[:, None] + np.arange(k)[None, :] * step[:, None]
        idx[np.arange(len(m)), m - 1] = bm1
        feed_idx = np.minimum(idx.astype(np.int64), n - 1)
        X = vs_s[feed_idx]
        g0 = 0
        for i in range(len(uniq)):
            if uniq[i] - uniq[g0] >= t0.cap:
                t0.accumulate_block(uniq[g0:i], counts[g0:i], sums[g0:i],
                                    mins[g0:i], maxs[g0:i], bads[g0:i],
                                    X[g0:i], m[g0:i])
                self._cascade(closed_only=True)
                g0 = i
        t0.accumulate_block(uniq[g0:], counts[g0:], sums[g0:], mins[g0:],
                            maxs[g0:], bads[g0:], X[g0:], m[g0:])
        self.pend_n = 0
        self._cascade(closed_only=True)
        return n

    def _cascade(self, closed_only: bool) -> None:
        """Merge finished finer buckets into their parent tiers.  With
        ``closed_only`` the still-open newest bucket of each tier stays;
        ``finalize`` passes False to push everything up."""
        for child, parent in zip(self.tiers, self.tiers[1:]):
            frontier = child.newest if closed_only else child.newest + 1
            # every occupied, not-yet-merged slot below the frontier —
            # including stragglers that already fell off the timeline
            todo = np.flatnonzero((child.ids >= child.merged_upto)
                                  & (child.ids < frontier))
            todo = todo[np.argsort(child.ids[todo], kind="stable")]
            ratio = int(round(parent.bucket_s / child.bucket_s))
            if len(todo):
                self._merge_block(child, parent, todo, ratio)
            if frontier > child.merged_upto:
                child.merged_upto = frontier

    @staticmethod
    def _merge_block(child: TierRing, parent: TierRing,
                     todo: np.ndarray, ratio: int) -> None:
        """Merge a batch of closed child slots (ascending by bucket id)
        into their parents in one block: aggregates reduce per parent
        group, and each child's deterministic ``sketch_feed`` lands in
        its parent's concatenated feed row in child order — the same
        per-parent sample sequence the one-at-a-time path produced."""
        cbids = child.ids[todo]
        pbids = cbids // ratio            # non-decreasing: groups contiguous
        # child feed matrix: bootstrap cells contribute their sorted
        # raw buf, mature cells each marker height x reps (capped)
        ccnt = child.sketch.count[todo, 0]
        reps = np.clip(ccnt // 5, 1, 8)
        clen = np.where(ccnt < 5, ccnt, 5 * reps)
        CF = np.zeros((len(todo), 40))
        for c in (1, 2, 3, 4):
            lanes = np.flatnonzero(ccnt == c)
            if len(lanes):
                CF[lanes[:, None], np.arange(c)[None, :]] = np.sort(
                    child.sketch.buf[todo[lanes], 0, :c], axis=1)
        mature = ccnt >= 5
        for r in np.unique(reps[mature]) if mature.any() else ():
            lanes = np.flatnonzero(mature & (reps == r))
            CF[lanes[:, None], np.arange(5 * r)[None, :]] = np.repeat(
                child.sketch.heights[todo[lanes], 0], r, axis=1)
        gstart = np.flatnonzero(np.diff(pbids, prepend=pbids[0] - 1))
        uniq = pbids[gstart]
        counts = np.add.reduceat(child.counts[todo], gstart)
        sums = np.add.reduceat(child.sums[todo], gstart)
        mins = np.minimum.reduceat(child.mins[todo], gstart)
        maxs = np.maximum.reduceat(child.maxs[todo], gstart)
        bads = np.add.reduceat(child.bad[todo], gstart)
        gsizes = np.diff(np.append(gstart, len(todo)))
        # per-child sums kept unreduced so the parent adds them in child
        # order (float association matches the scalar merge exactly)
        SC = np.zeros((len(uniq), int(gsizes.max())))
        rank = np.arange(len(todo)) - np.repeat(gstart, gsizes)
        pidx = np.repeat(np.arange(len(uniq)), gsizes)
        SC[pidx, rank] = child.sums[todo]
        # scatter child feeds into per-parent rows at running offsets
        PL = np.add.reduceat(clen, gstart)
        cum = np.cumsum(clen) - clen      # global feed offset per child
        off = cum - (np.cumsum(PL) - PL)[pidx]
        tot = int(clen.sum())
        X = np.zeros((len(uniq), int(PL.max()) if len(PL) else 0))
        if tot:
            flat_child = np.repeat(np.arange(len(todo)), clen)
            within = np.arange(tot) - np.repeat(cum, clen)
            X[pidx[flat_child], np.repeat(off, clen) + within] = \
                CF[flat_child, within]
        parent.accumulate_block(uniq, counts, sums, mins, maxs, bads,
                                X, PL, drop_weights=gsizes,
                                sum_chunks=SC, chunk_len=gsizes)

    def finalize(self, sketch_samples: int) -> None:
        self.fold(sketch_samples)
        self._cascade(closed_only=False)

    # -- reads --------------------------------------------------------

    def series(self, tier: int):
        """(ids, counts, sums, mins, maxs, bad, q) of live buckets of one
        tier, ascending by bucket id."""
        ring = self.tiers[tier]
        slots = ring.live_order()
        q = np.array([ring.quantile_value(s) for s in slots])
        return (ring.ids[slots].copy(), ring.counts[slots].copy(),
                ring.sums[slots].copy(), ring.mins[slots].copy(),
                ring.maxs[slots].copy(), ring.bad[slots].copy(), q)


class TelemetryEngine:
    """The live subscriber.  ``observe``/``observe_many`` are the ingest
    taps (called under an ``is None`` guard from ``MetricsRegistry``);
    ``record_health`` is the platform-side tap.  Metrics outside
    ``cfg.metrics`` are filtered here in O(1) so hot ingest paths never
    buffer series nobody reads."""

    def __init__(self, cfg: Optional[TelemetryConfig] = None):
        self.cfg = cfg or TelemetryConfig()
        self._want = frozenset(self.cfg.metrics)
        self.series: Dict[Tuple[str, str, str], SeriesRollup] = {}
        self.slo_thr: Dict[str, float] = {}   # fn -> response-time SLO
        self._pending = 0                     # samples since last flush
        self.folded = 0                       # lifetime samples folded
        self.flushes = 0

    # -- subscription surface -----------------------------------------

    def set_slo(self, fn: str, threshold_s: float) -> None:
        """Register a function's SLO threshold; response_time buckets
        then count ``bad`` samples (> threshold) for burn-rate math."""
        self.slo_thr[fn] = float(threshold_s)
        for (p, f, m), sr in self.series.items():
            if f == fn and m == "response_time":
                sr.thr = float(threshold_s)

    def _series(self, platform: str, fn: str,
                metric: str) -> SeriesRollup:
        key = (platform, fn, metric)
        sr = self.series.get(key)
        if sr is None:
            thr = (self.slo_thr.get(fn, np.inf)
                   if metric == "response_time" else np.inf)
            sr = SeriesRollup(self.cfg, thr)
            self.series[key] = sr
        return sr

    def observe(self, platform: str, fn: str, metric: str,
                t: float, v: float) -> None:
        if metric not in self._want:
            return
        self._series(platform, fn, metric).add(t, v)
        self._pending += 1
        self._maybe_flush()

    def observe_many(self, platform: str, fn: str, metric: str,
                     ts: np.ndarray, vs: np.ndarray) -> None:
        if metric not in self._want:
            return
        self._series(platform, fn, metric).add_many(ts, vs)
        self._pending += len(ts)
        self._maybe_flush()

    def record_health(self, platform: str, t: float, queue_rows: float,
                      utilization: float, watts: float) -> None:
        """Platform drain/heartbeat tap: per-platform health samples on
        the fn-less ``'-'`` slot."""
        sr = self._series(platform, NO_FN, "queue_depth")
        sr.add(t, float(queue_rows))
        sr = self._series(platform, NO_FN, "utilization")
        sr.add(t, float(utilization))
        sr = self._series(platform, NO_FN, "watts")
        sr.add(t, float(watts))
        self._pending += 3
        self._maybe_flush()

    # -- folding ------------------------------------------------------

    def _maybe_flush(self) -> None:
        lim = self.cfg.auto_flush_samples
        if lim is not None and self._pending >= lim:
            self.flush()

    def flush(self) -> int:
        """Fold every pending buffer into the tier rings.  Bounded work:
        O(pending) plus O(live buckets) cascade."""
        folded = 0
        k = self.cfg.sketch_samples
        for sr in self.series.values():
            folded += sr.fold(k)
        self._pending = 0
        self.folded += folded
        self.flushes += 1
        return folded

    def finalize(self) -> None:
        """End-of-run flush that also cascades the still-open buckets so
        coarse tiers cover the full horizon."""
        k = self.cfg.sketch_samples
        for sr in self.series.values():
            self.folded += sr.pend_n
            sr.finalize(k)
        self._pending = 0
        self.flushes += 1

    # -- reads --------------------------------------------------------

    def keys(self) -> List[Tuple[str, str, str]]:
        return sorted(self.series.keys())

    def get_series(self, platform: str, fn: str, metric: str,
                   tier: int = 0):
        sr = self.series.get((platform, fn, metric))
        if sr is None:
            return None
        return sr.series(tier)

    def dropped_late(self) -> int:
        return sum(t.dropped_late for sr in self.series.values()
                   for t in sr.tiers)

    def rollup_summary(self) -> Dict:
        """Canonical-JSON-friendly summary for the report section."""
        return {
            "tiers_s": [float(t) for t in self.cfg.tiers_s],
            "capacity": int(self.cfg.capacity),
            "keys": len(self.series),
            "samples": int(self.folded),
            "flushes": int(self.flushes),
            "dropped_late": int(self.dropped_late()),
        }
