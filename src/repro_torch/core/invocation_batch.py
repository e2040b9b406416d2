"""Struct-of-arrays invocation batches: the array-native admission
currency.

An ``InvocationBatch`` carries an arrival burst as flat columns — function
index, arrival timestamp, payload bytes, SLO deadline, QoS class, tenant,
admission state — over one shared list of distinct ``FunctionSpec``s.  The
whole admission pipeline (gateway -> control plane -> sidecar -> platform
queue) moves the columns; per-invocation ``Invocation`` objects materialize
lazily, exactly when a replica actually starts one (or a fault / completion
path needs the object form).  A trace replay therefore allocates Python
objects proportional to *in-flight* work, not to arrivals, and a long
stream can be walked as zero-copy chunk ``view``s over one preallocated
column set.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.types import FunctionSpec, Invocation


class InvocationBatch:
    """One arrival burst in struct-of-arrays form.

    Columns (length ``n``, NumPy; ``view`` slices share memory with the
    parent so admission-state writes propagate):

    * ``fn_idx``  (int32)  — index into ``specs`` per arrival
    * ``arrival_t`` (f8)   — arrival timestamp (sim seconds)
    * ``payload_bytes`` (f8) — request payload size (0 when unknown)
    * ``deadline_s`` (f8)  — per-arrival SLO budget (from the spec's SLO
      unless the caller supplies its own column)
    * ``qos``     (int8)   — QoS class id (core.qos; 1 == standard)
    * ``tenant``  (int32)  — tenant id (0 == default tenant)
    * ``state``   (int8)   — PENDING / ADMITTED / REJECTED
    """

    PENDING, ADMITTED, REJECTED = 0, 1, 2

    __slots__ = ("specs", "fn_idx", "arrival_t", "payload_bytes",
                 "deadline_s", "state", "qos", "tenant", "decision", "n",
                 "arrival_recorded", "_objs")

    def __init__(self, specs: Sequence[FunctionSpec], fn_idx, arrival_t,
                 payload_bytes=None, deadline_s=None, state=None,
                 qos=None, tenant=None, decision=None):
        self.specs: List[FunctionSpec] = \
            specs if isinstance(specs, list) else list(specs)
        self.fn_idx = np.asarray(fn_idx, np.int32)
        self.arrival_t = np.asarray(arrival_t, np.float64)
        n = int(self.fn_idx.size)
        self.n = n
        if payload_bytes is None:
            payload_bytes = np.zeros(n)
        self.payload_bytes = np.asarray(payload_bytes, np.float64)
        if deadline_s is None:
            slo = np.array([s.slo.p90_response_s for s in self.specs],
                           np.float64)
            deadline_s = slo[self.fn_idx] if n else np.empty(0)
        self.deadline_s = np.asarray(deadline_s, np.float64)
        self.state = np.zeros(n, np.int8) if state is None \
            else np.asarray(state, np.int8)
        # 1 == standard (repro_torch.core.qos.DEFAULT_QOS); kept literal so a
        # qos-free caller never imports the qos module
        self.qos = np.full(n, 1, np.int8) if qos is None \
            else np.asarray(qos, np.int8)
        self.tenant = np.zeros(n, np.int32) if tenant is None \
            else np.asarray(tenant, np.int32)
        # decision-journal row id per arrival (-1 == not journaled); the
        # control plane stamps it at admission when provenance is on
        self.decision = np.full(n, -1, np.int64) if decision is None \
            else np.asarray(decision, np.int64)
        # set once the control plane has folded this batch's arrivals into
        # the rate/interaction models (mirrors Invocation.arrival_recorded)
        self.arrival_recorded = False
        self._objs: Dict[int, Invocation] = {}

    def __len__(self) -> int:
        return self.n

    # ------------------------------------------------------------ views --
    def view(self, lo: int, hi: int) -> "InvocationBatch":
        """Zero-copy sub-batch over rows ``[lo, hi)``: columns are NumPy
        views into the parent (state writes propagate back); the lazy
        object cache is per-view."""
        return InvocationBatch(self.specs, self.fn_idx[lo:hi],
                               self.arrival_t[lo:hi],
                               self.payload_bytes[lo:hi],
                               self.deadline_s[lo:hi],
                               self.state[lo:hi],
                               qos=self.qos[lo:hi],
                               tenant=self.tenant[lo:hi],
                               decision=self.decision[lo:hi])

    # ------------------------------------------------- object round-trip --
    def materialize(self, i: int) -> Invocation:
        """The ``Invocation`` object for row ``i``, created on first use
        and cached (hooks and fault paths must see one identity per row)."""
        inv = self._objs.get(i)
        if inv is None:
            inv = Invocation(self.specs[self.fn_idx[i]],
                             float(self.arrival_t[i]),
                             qos=int(self.qos[i]),
                             tenant=int(self.tenant[i]))
            inv.decision = int(self.decision[i])
            self._objs[i] = inv
        return inv

    def to_invocations(self) -> List[Invocation]:
        """Materialize every row, in arrival order (the object-path
        fallback: stateful policies, decision-row logging, hedging)."""
        return [self.materialize(i) for i in range(self.n)]

    @classmethod
    def from_invocations(cls, invs: Sequence[Invocation],
                         payload_bytes=None) -> "InvocationBatch":
        """Columnarize existing objects (specs dedupe by identity, first-
        appearance order — the mirror of ``scheduler.group_by_fn``).  The
        originals are kept as the row cache, so a round trip through
        ``to_invocations`` returns the very same objects."""
        n = len(invs)
        specs: List[FunctionSpec] = []
        smap: Dict[int, int] = {}
        fidx = np.empty(n, np.int32)
        arr = np.empty(n)
        qos = np.empty(n, np.int8)
        tenant = np.empty(n, np.int32)
        decision = np.empty(n, np.int64)
        for i, inv in enumerate(invs):
            j = smap.get(id(inv.fn))
            if j is None:
                j = len(specs)
                smap[id(inv.fn)] = j
                specs.append(inv.fn)
            fidx[i] = j
            arr[i] = inv.arrival_t
            qos[i] = inv.qos
            tenant[i] = inv.tenant
            decision[i] = inv.decision
        b = cls(specs, fidx, arr, payload_bytes=payload_bytes,
                qos=qos, tenant=tenant, decision=decision)
        b._objs = dict(enumerate(invs))
        return b

    # ------------------------------------------------------ group helper --
    def present_fns(self) -> np.ndarray:
        """Distinct ``specs`` indices present in this batch, first-
        appearance order (so columnar routing admits groups in exactly the
        order the object path's identity grouping would)."""
        uniq, first = np.unique(self.fn_idx, return_index=True)
        return uniq[np.argsort(first, kind="stable")]
