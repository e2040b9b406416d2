"""Vectorized latency decomposition over flight-recorder span columns.

``decompose`` folds the lifecycle spans of each traced invocation into a
``(n, 6)`` segment matrix whose rows sum *exactly* to the invocation's
response time: ingress, queue, cold start, prewarm start and data staging
are taken from the recorded intervals, and execution is defined as the
residual ``response - sum(others)``.  The recorder stores EXEC end times
bit-identical to the clock-scheduled completion instants, so the residual
differs from the raw recorded exec duration only by float re-association
(reported as ``exec_residual_err`` and pinned tiny by test) — while the
reconciliation against the result sink's ``end - arrival`` is bitwise.

On top of the decomposition: ``slo_attribution`` names the dominant
segment of every SLO-violating invocation (the paper's "why did p90
blow" question), ``chain_critical_paths`` chains chain-stage spans
backwards through completion==ready edges, and
``latency_breakdown_section`` packages everything as a plain-JSON report
section.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.obs.recorder import (CHAIN_STAGE, EXEC, INGRESS, LIFECYCLE,
                                      SEGMENT_NAMES, FlightRecorder)


@dataclass
class Decomposition:
    """Per-invocation segment matrix for every *completed* traced row.

    ``segments[i]`` sums exactly to ``response[i]`` (exec is the
    residual); ``attempts[i]`` is the launch attempt the segments came
    from (redelivered invocations keep only their final attempt).
    """
    inv: np.ndarray            # int64 invocation ids, sorted ascending
    fn: np.ndarray             # int32 recorder fn ids
    platform: np.ndarray       # int16 recorder platform ids
    arrival: np.ndarray        # float64 arrival instants
    response: np.ndarray       # float64 end - arrival (bitwise vs sink)
    segments: np.ndarray       # (n, LIFECYCLE) float64, rows sum == response
    attempts: np.ndarray       # int64
    exec_residual_err: float   # max |residual - recorded exec duration|


def decompose(rec: FlightRecorder) -> Decomposition:
    cols = rec.spans.columns()
    kind = cols["kind"]
    inv = cols["inv"]
    mask = (kind < LIFECYCLE) & (inv >= 0)
    if not mask.any():
        z = np.empty(0)
        return Decomposition(np.empty(0, np.int64), np.empty(0, np.int32),
                             np.empty(0, np.int16), z, z,
                             np.empty((0, LIFECYCLE)),
                             np.empty(0, np.int64), 0.0)
    inv = inv[mask]
    kind = kind[mask].astype(np.int64)
    t0 = cols["t0"][mask]
    t1 = cols["t1"][mask]
    plat = cols["platform"][mask]
    fn = cols["fn"][mask]
    att = cols["link"][mask]

    uids, inverse = np.unique(inv, return_inverse=True)
    n = uids.size
    # Redelivered invocations launch more than once; keep only the spans
    # of the final attempt so segments describe the completing run.
    maxatt = np.full(n, np.iinfo(np.int64).min, np.int64)
    np.maximum.at(maxatt, inverse, att)
    keep = att == maxatt[inverse]
    inverse = inverse[keep]
    kind = kind[keep]
    t0 = t0[keep]
    t1 = t1[keep]
    plat = plat[keep]
    fn = fn[keep]
    att = att[keep]

    seg = np.bincount(inverse * LIFECYCLE + kind, weights=t1 - t0,
                      minlength=n * LIFECYCLE).reshape(n, LIFECYCLE)

    arrival = np.zeros(n)
    end = np.zeros(n)
    row_fn = np.zeros(n, np.int32)
    row_plat = np.zeros(n, np.int16)
    row_att = np.zeros(n, np.int64)
    has_ing = np.zeros(n, bool)
    has_exec = np.zeros(n, bool)
    ing = kind == INGRESS
    arrival[inverse[ing]] = t0[ing]
    has_ing[inverse[ing]] = True
    ex = kind == EXEC
    end[inverse[ex]] = t1[ex]
    row_fn[inverse[ex]] = fn[ex]
    row_plat[inverse[ex]] = plat[ex]
    row_att[inverse[ex]] = att[ex]
    has_exec[inverse[ex]] = True

    complete = has_ing & has_exec
    uids = uids[complete]
    seg = seg[complete]
    arrival = arrival[complete]
    end = end[complete]
    row_fn = row_fn[complete]
    row_plat = row_plat[complete]
    row_att = row_att[complete]

    response = end - arrival
    # Exec becomes the residual so rows reconcile with response exactly;
    # the recorded exec interval is kept only to bound the substitution.
    raw_exec = seg[:, EXEC].copy()
    others = seg.copy()
    others[:, EXEC] = 0.0
    seg[:, EXEC] = response - others.sum(axis=1)
    err = float(np.abs(seg[:, EXEC] - raw_exec).max()) if uids.size else 0.0
    return Decomposition(uids, row_fn, row_plat, arrival, response, seg,
                         row_att, err)


def reconcile(decomp: Decomposition, sink_cols: Dict[str, Any]
              ) -> Dict[str, Any]:
    """Join decomposition rows to the result sink by invocation id and
    compare the traced ``end - arrival`` to the sink's — bitwise."""
    inv_id = np.asarray(sink_cols["inv_id"], np.int64)
    rt_sink = (np.asarray(sink_cols["end"], float)
               - np.asarray(sink_cols["arrival"], float))
    order = np.argsort(inv_id, kind="stable")
    pos = np.searchsorted(inv_id[order], decomp.inv)
    pos = np.clip(pos, 0, max(inv_id.size - 1, 0))
    if inv_id.size:
        hit = inv_id[order][pos] == decomp.inv
    else:
        hit = np.zeros(decomp.inv.size, bool)
    rt = rt_sink[order][pos]
    matched = int(hit.sum())
    if matched:
        diff = np.abs(decomp.response[hit] - rt[hit])
        exact = int((decomp.response[hit] == rt[hit]).sum())
        max_err = float(diff.max())
    else:
        exact, max_err = 0, 0.0
    return {"traced": int(decomp.inv.size), "matched": matched,
            "exact": exact, "max_err_s": max_err}


def slo_attribution(decomp: Decomposition, rec: FlightRecorder,
                    fns: Dict[str, Any]) -> Dict[str, Any]:
    """For each traced invocation violating its function's p90-response
    SLO, name the dominant latency segment — the "why" behind the
    report's violation counts."""
    fn_names = rec.fn_names()
    thr = np.full(len(fn_names), np.inf)
    for i, name in enumerate(fn_names):
        fn = fns.get(name)
        if fn is not None:
            thr[i] = fn.slo.p90_response_s
    if decomp.inv.size == 0 or not fn_names:
        return {"violations": 0, "dominant_segment": {}, "per_function": {}}
    viol = decomp.response > thr[decomp.fn]
    dom = np.argmax(decomp.segments, axis=1)
    counts = np.bincount(dom[viol], minlength=LIFECYCLE)
    per_fn: Dict[str, Any] = {}
    for i, name in enumerate(fn_names):
        m = viol & (decomp.fn == i)
        nv = int(m.sum())
        if nv == 0:
            continue
        fdom = np.bincount(dom[m], minlength=LIFECYCLE)
        per_fn[name] = {"violations": nv,
                        "dominant": SEGMENT_NAMES[int(fdom.argmax())]}
    return {
        "violations": int(viol.sum()),
        "dominant_segment": {SEGMENT_NAMES[k]: int(counts[k])
                             for k in range(LIFECYCLE) if counts[k]},
        "per_function": per_fn,
    }


def chain_critical_paths(rec: FlightRecorder, tol: float = 1e-6
                         ) -> Dict[str, Any]:
    """Chain-stage spans record ``[ready, completed)`` per stage, and the
    executor releases a stage exactly at its last predecessor's completion
    instant — so walking backwards from the final completion through
    ``|pred.t1 - cur.t0| <= tol`` edges recovers each instance's critical
    path."""
    cols = rec.spans.columns()
    m = cols["kind"] == CHAIN_STAGE
    if not m.any():
        return {"instances": 0, "mean_critical_s": 0.0, "stage_counts": {}}
    t0 = cols["t0"][m]
    t1 = cols["t1"][m]
    fn = cols["fn"][m]
    link = cols["link"][m]
    fn_names = rec.fn_names()
    insts = np.unique(link)
    crit_total = 0.0
    stage_counts: Dict[str, int] = {}
    for inst in insts:
        rows = np.flatnonzero(link == inst)
        it0, it1, ifn = t0[rows], t1[rows], fn[rows]
        cur = int(np.argmax(it1))
        crit = 0.0
        visited = set()
        while True:
            visited.add(cur)
            crit += it1[cur] - it0[cur]
            name = fn_names[ifn[cur]] if 0 <= ifn[cur] < len(fn_names) \
                else str(int(ifn[cur]))
            stage_counts[name] = stage_counts.get(name, 0) + 1
            preds = np.flatnonzero(np.abs(it1 - it0[cur]) <= tol)
            preds = [p for p in preds if p not in visited]
            if not preds:
                break
            cur = max(preds, key=lambda p: it1[p])
        crit_total += crit
    return {"instances": int(insts.size),
            "mean_critical_s": float(crit_total / insts.size),
            "stage_counts": dict(sorted(stage_counts.items()))}


def latency_breakdown_section(rec: Optional[FlightRecorder],
                              sink_cols: Dict[str, Any],
                              fns: Dict[str, Any]) -> Dict[str, Any]:
    """The ``latency_breakdown`` block of ``ScenarioReport`` — native
    Python scalars only, so the canonical-JSON bytes stay stable."""
    if rec is None:
        return {}
    decomp = decompose(rec)
    rc = reconcile(decomp, sink_cols)
    totals = decomp.segments.sum(axis=0) if decomp.inv.size \
        else np.zeros(LIFECYCLE)
    grand = float(totals.sum())
    section: Dict[str, Any] = {
        "enabled": True,
        "sample": float(rec.sample),
        "spans": int(rec.spans.n),
        "traced_invocations": rc["traced"],
        "matched_completions": rc["matched"],
        "exact_reconciled": rc["exact"],
        "max_reconcile_err_s": rc["max_err_s"],
        "exec_residual_err_s": float(decomp.exec_residual_err),
        "segment_totals_s": {SEGMENT_NAMES[k]: float(totals[k])
                             for k in range(LIFECYCLE)},
        "segment_share": {SEGMENT_NAMES[k]:
                          (float(totals[k]) / grand if grand > 0.0 else 0.0)
                          for k in range(LIFECYCLE)},
        "slo_attribution": slo_attribution(decomp, rec, fns),
    }
    cp = chain_critical_paths(rec)
    if cp["instances"]:
        section["chain_critical_path"] = cp
    return section
