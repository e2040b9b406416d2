"""Flight recorder: array-native invocation-lifecycle tracing.

``SpanBuffer`` is the storage — grow-by-doubling NumPy columns, one row
per recorded span: invocation id (``-1`` for aggregate/control spans),
segment kind, ``[t0, t1)`` sim-time bounds, interned platform and function
ids, and a generic ``link`` column (attempt index for lifecycle spans,
the original invocation for hedge duplicates, the chain-instance id for
chain-stage spans, the group size for admission/pool spans).

``FlightRecorder`` is the tap surface the core calls into.  Every tap
site guards with ``if recorder is not None`` — the disabled path costs
one attribute read per admission burst, nothing per invocation.  All
per-invocation lifecycle segments are recorded from the single launch
tap (``TargetPlatform._launch``), where arrival, queue-entry, startup,
data-staging and execution times are all known at once, so the object
and columnar admission paths produce identical traces.

Sampling is deterministic and head-based: an invocation is traced iff a
multiplicative hash of its id falls under ``sample`` — every segment of
one invocation is kept or dropped together, and two runs of one seeded
scenario record byte-identical span columns.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# lifecycle segment kinds (the latency decomposition, exclusive intervals)
INGRESS, QUEUE, COLD_START, PREWARM_START, DATA, EXEC = range(6)
LIFECYCLE = 6                       # kinds < LIFECYCLE decompose response
# control/aggregate kinds
ADMIT, REJECT, HEDGE, CHAIN_STAGE, POOL_PREWARM, POOL_RETIRE = range(6, 12)

KIND_NAMES = ("ingress", "queue", "cold_start", "prewarm_start", "data",
              "exec", "admit", "reject", "hedge", "chain_stage",
              "pool_prewarm", "pool_retire")
SEGMENT_NAMES = KIND_NAMES[:LIFECYCLE]

_HASH_MULT = np.uint64(2654435761)          # Knuth multiplicative hash
_HASH_MASK = np.uint64(0xFFFFFFFF)


class SpanBuffer:
    """Grow-by-doubling span columns (struct-of-arrays, PR-6 discipline)."""

    __slots__ = ("_inv", "_kind", "_t0", "_t1", "_platform", "_fn",
                 "_link", "_n")

    def __init__(self, capacity: int = 1024):
        capacity = max(int(capacity), 1)
        self._inv = np.empty(capacity, np.int64)
        self._kind = np.empty(capacity, np.int8)
        self._t0 = np.empty(capacity)
        self._t1 = np.empty(capacity)
        self._platform = np.empty(capacity, np.int16)
        self._fn = np.empty(capacity, np.int32)
        self._link = np.empty(capacity, np.int64)
        self._n = 0

    @property
    def n(self) -> int:
        return self._n

    def _grow(self, need: int):
        cap = max(self._inv.size * 2, need)
        for name in ("_inv", "_kind", "_t0", "_t1", "_platform", "_fn",
                     "_link"):
            a = getattr(self, name)
            b = np.empty(cap, a.dtype)
            b[:self._n] = a[:self._n]
            setattr(self, name, b)

    def add(self, inv: int, kind: int, t0: float, t1: float,
            platform: int, fn: int, link: int):
        i = self._n
        if i == self._inv.size:
            self._grow(i + 1)
        self._inv[i] = inv
        self._kind[i] = kind
        self._t0[i] = t0
        self._t1[i] = t1
        self._platform[i] = platform
        self._fn[i] = fn
        self._link[i] = link
        self._n = i + 1

    def add_many(self, inv, kind, t0, t1, platform, fn, link):
        """Bulk append of parallel span columns (one slice copy each)."""
        inv = np.asarray(inv, np.int64)
        k = inv.size
        if k == 0:
            return
        need = self._n + k
        if need > self._inv.size:
            self._grow(need)
        lo, hi = self._n, need
        self._inv[lo:hi] = inv
        self._kind[lo:hi] = kind
        self._t0[lo:hi] = t0
        self._t1[lo:hi] = t1
        self._platform[lo:hi] = platform
        self._fn[lo:hi] = fn
        self._link[lo:hi] = link
        self._n = need

    def columns(self) -> Dict[str, np.ndarray]:
        """Trimmed views (not copies) of the recorded spans."""
        n = self._n
        return {"inv": self._inv[:n], "kind": self._kind[:n],
                "t0": self._t0[:n], "t1": self._t1[:n],
                "platform": self._platform[:n], "fn": self._fn[:n],
                "link": self._link[:n]}


class FlightRecorder:
    """The tap surface: interned ids + sampling over one ``SpanBuffer``."""

    def __init__(self, sample: float = 1.0, capacity: int = 1024):
        self.sample = min(max(float(sample), 0.0), 1.0)
        self._threshold = np.uint64(int(self.sample * float(2 ** 32)))
        self.spans = SpanBuffer(capacity)
        self._pids: Dict[str, int] = {}
        self._fids: Dict[str, int] = {}

    # ----------------------------------------------------------- intern ---
    def platform_id(self, name: Optional[str]) -> int:
        if name is None:
            return -1
        pid = self._pids.get(name)
        if pid is None:
            pid = len(self._pids)
            self._pids[name] = pid
        return pid

    def fn_id(self, name: Optional[str]) -> int:
        if name is None:
            return -1
        fid = self._fids.get(name)
        if fid is None:
            fid = len(self._fids)
            self._fids[name] = fid
        return fid

    def platform_names(self) -> List[str]:
        return list(self._pids)

    def fn_names(self) -> List[str]:
        return list(self._fids)

    # --------------------------------------------------------- sampling ---
    def keep_mask(self, ids: np.ndarray) -> np.ndarray:
        """Deterministic head-based sampling decision per invocation id."""
        if self.sample >= 1.0:
            return np.ones(ids.size, bool)
        h = (ids.astype(np.uint64) * _HASH_MULT) & _HASH_MASK
        return h < self._threshold

    def keep(self, inv_id: int) -> bool:
        if self.sample >= 1.0:
            return True
        h = (np.uint64(inv_id) * _HASH_MULT) & _HASH_MASK
        return bool(h < self._threshold)

    def traced_invocations(self) -> int:
        """Distinct invocations with at least one lifecycle span."""
        cols = self.spans.columns()
        mask = (cols["kind"] < LIFECYCLE) & (cols["inv"] >= 0)
        return int(np.unique(cols["inv"][mask]).size)

    # ------------------------------------------------------ launch tap  ---
    def record_launch(self, invs: Sequence, fns: Sequence, pname: str,
                      now: float, startups, data_ts, end_ts, colds):
        """The one tap that yields the whole per-invocation decomposition
        (called from ``TargetPlatform._launch``, scalar and vectorized
        paths alike).  ``end_ts`` must be the exact values the finish
        callbacks are scheduled at — ``inv.end_t`` bit-for-bit — so the
        recorded segments reconcile exactly with ``response_time``.

        Segments per started row: ingress ``[arrival, scheduled)``, queue
        ``[scheduled, now)``, cold/prewarm start ``[now, now+startup)``
        when a container had to start, data staging and execution filling
        ``[now+startup, end)``.
        """
        n = len(invs)
        ids = np.fromiter((inv.id for inv in invs), np.int64, n)
        keep = self.keep_mask(ids)
        if not keep.any():
            return
        idx = np.flatnonzero(keep)
        ids = ids[idx]
        startup = np.asarray(startups, float)[idx]
        data = np.asarray(data_ts, float)[idx]
        end = np.asarray(end_ts, float)[idx]
        cold = np.asarray(colds, bool)[idx]
        arrival = np.fromiter((invs[i].arrival_t for i in idx),
                              float, idx.size)
        sched = np.fromiter(
            (invs[i].scheduled_t if invs[i].scheduled_t is not None
             else now for i in idx), float, idx.size)
        att = np.fromiter((invs[i].attempts for i in idx),
                          np.int64, idx.size)
        fid = np.fromiter((self.fn_id(fns[i].name) for i in idx),
                          np.int32, idx.size)
        pid = self.platform_id(pname)
        k = idx.size
        start = now + startup
        dstop = start + data

        inv_cols = [ids, ids, ids]
        kind_cols = [np.full(k, INGRESS, np.int8),
                     np.full(k, QUEUE, np.int8),
                     np.full(k, EXEC, np.int8)]
        t0_cols = [arrival, sched, dstop]
        t1_cols = [sched, np.full(k, now), end]
        fn_cols = [fid, fid, fid]
        link_cols = [att, att, att]
        su = np.flatnonzero(startup > 0.0)
        if su.size:
            inv_cols.append(ids[su])
            kind_cols.append(np.where(cold[su], COLD_START,
                                      PREWARM_START).astype(np.int8))
            t0_cols.append(np.full(su.size, now))
            t1_cols.append(start[su])
            fn_cols.append(fid[su])
            link_cols.append(att[su])
        da = np.flatnonzero(data > 0.0)
        if da.size:
            inv_cols.append(ids[da])
            kind_cols.append(np.full(da.size, DATA, np.int8))
            t0_cols.append(start[da])
            t1_cols.append(dstop[da])
            fn_cols.append(fid[da])
            link_cols.append(att[da])
        self.spans.add_many(np.concatenate(inv_cols),
                            np.concatenate(kind_cols),
                            np.concatenate(t0_cols),
                            np.concatenate(t1_cols),
                            pid,
                            np.concatenate(fn_cols),
                            np.concatenate(link_cols))

    # ------------------------------------------------- control-path taps --
    def record_admit(self, fn_name: str, pname: str, t: float, count: int):
        """One admission-decision span per (fn, platform) group — both the
        object and the columnar submit paths record groups, keeping their
        traces aligned.  ``link`` carries the group size."""
        self.spans.add(-1, ADMIT, t, t, self.platform_id(pname),
                       self.fn_id(fn_name), count)

    def record_reject(self, fn_name: Optional[str], pname: Optional[str],
                      t: float, count: int):
        self.spans.add(-1, REJECT, t, t, self.platform_id(pname),
                       self.fn_id(fn_name), count)

    def record_hedge(self, dup, orig, t: float):
        """Speculative duplicate spawned: the dup's lifecycle spans appear
        at its own launch; this span links it back to the original."""
        self.spans.add(dup.id, HEDGE, t, t, -1,
                       self.fn_id(dup.fn.name), orig.id)

    def record_chain_stage(self, inst_id: int, inv_id: int, fn_name: str,
                           pname: Optional[str], t0: float, t1: float):
        """One span per completed chain stage: ``[ready, completed)``,
        linked to the chain instance — the edges the critical-path
        extraction chains backwards through."""
        self.spans.add(inv_id, CHAIN_STAGE, t0, t1,
                       self.platform_id(pname), self.fn_id(fn_name),
                       inst_id)

    def record_prewarm(self, pname: str, fn_name: str, t: float, n: int):
        self.spans.add(-1, POOL_PREWARM, t, t, self.platform_id(pname),
                       self.fn_id(fn_name), n)

    def record_retire(self, pname: str, fn_name: str, t: float, n: int):
        self.spans.add(-1, POOL_RETIRE, t, t, self.platform_id(pname),
                       self.fn_id(fn_name), n)
