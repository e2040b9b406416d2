"""Decision journal: columnar provenance for the admission fast path.

``DecisionJournal`` records one row per fused ``fn_decisions`` decision
(one per distinct function per admitted burst) into grow-by-doubling
NumPy columns — the flight-recorder discipline: every tap site guards
with ``if journal is not None``, so the provenance-off path costs one
attribute read per burst and the pinned 1.6M decisions/s columnar floor
holds.

Each row snapshots the *full* standard feature set the stateless policy
cascades are pure functions of (``repro_torch.core.scheduler
.decision_features``): per-candidate exec/data/P90/energy predictions,
warm-pool, utilization and cold-start columns, the function's SLO — plus
the decision itself: chosen platform slot, runner-up slot and cost
margin, and the per-candidate filter-kill bitmask (``KILL_DEAD`` /
``KILL_UTIL`` / ``KILL_SLO``; 0 == feasible after graceful degrade).
Because the features are policy-agnostic, an offline what-if replay
(``repro_torch.obs.whatif``) can re-score the journaled columns under *any*
stateless policy or alternate QoS config; re-scoring under the same
policy reproduces the original choices byte-identically (the
correctness oracle — the cascades mirror ``fn_cost_matrix`` op for op).

The journal row id is stamped onto every invocation the decision routed
(``Invocation.decision`` / ``InvocationBatch.decision`` ->
``ColumnarResultSink._decision``), so joining journal rows to sink
completions is direct fancy indexing — the calibration analyzer
(``decision_provenance_section``) computes per-(function, platform)
predicted-vs-realized latency error, per-filter kill counts, decision
regret and policy-churn stats fully vectorized.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.scheduler import (KILL_DEAD, KILL_SLO, KILL_UTIL,
                                        decision_features)

# 2D float feature columns, (rows, Pmax), NaN-padded past each row's
# platform-set size.  Order is the .npz layout contract.
FEATURE_COLS = ("exec_s", "data_s", "p90_s", "energy_j", "warm_free",
                "cold_start_s", "cpu_util", "mem_util")

# kill value for padding slots past a row's platform-set size (all bits
# set: a pad slot is never alive, never feasible)
KILL_PAD = 255

KILL_NAMES = {KILL_DEAD: "dead", KILL_UTIL: "utilization",
              KILL_SLO: "slo"}

_1D = ("_t", "_fn", "_count", "_pset", "_choice", "_runner", "_margin",
       "_slo_s")


class DecisionJournal:
    """Grow-by-doubling decision provenance columns.

    1D columns (one per journaled decision row):
      * ``t``      (f8)    — decision sim-time
      * ``fn``     (int32) — interned function-name id (``fn_names``)
      * ``count``  (int32) — invocations this decision routed
      * ``pset``   (int32) — interned platform-set id (``pset_names``,
        candidate order == snapshot order == slot order)
      * ``choice`` (int16) — chosen platform *slot* (-1 == infeasible)
      * ``runner`` (int16) — runner-up slot (-1 when < 2 feasible)
      * ``margin`` (f8)    — runner-up cost minus chosen cost (inf when
        no runner-up)
      * ``slo_s``  (f8)    — the function's P90 SLO budget

    2D columns (rows x Pmax, NaN / False / ``KILL_PAD`` padded): the
    ``FEATURE_COLS`` feature matrices, the ``alive`` mask and the
    ``kill`` bitmask.

    The hot-path ``record`` only *appends*: features, liveness and the
    backend's choice.  The derived columns — per-candidate ``kill``
    bits, runner-up slot and cost margin — are pure functions of the
    journaled features (the policy cascade re-run), so they are
    computed lazily in one vectorized pass the first time ``columns``
    is read, keeping per-burst recording cost inside the 15%
    provenance-overhead gate.
    """

    def __init__(self, capacity: int = 1024):
        cap = max(int(capacity), 1)
        self._n = 0
        self._pmax = 0
        self._t = np.empty(cap)
        self._fn = np.empty(cap, np.int32)
        self._count = np.empty(cap, np.int32)
        self._pset = np.empty(cap, np.int32)
        self._choice = np.empty(cap, np.int16)
        self._runner = np.empty(cap, np.int16)
        self._margin = np.empty(cap)
        self._slo_s = np.empty(cap)
        self._f2: Dict[str, np.ndarray] = \
            {name: np.empty((cap, 0)) for name in FEATURE_COLS}
        self._alive = np.zeros((cap, 0), bool)
        self._kill = np.empty((cap, 0), np.uint8)
        self._derived_n = 0        # rows with kill/runner/margin computed
        self._fn_ids: Dict[str, int] = {}
        self.fn_names: List[str] = []
        self._pset_ids: Dict[tuple, int] = {}
        self.pset_names: List[tuple] = []
        # bound by ControlPlane.attach_provenance
        self.perf = None
        self.placement = None
        self.policy_name: Optional[str] = None
        self.params: Dict[str, float] = {}
        self._cascade = None

    # ----------------------------------------------------------- wiring --
    def bind(self, policy, perf, placement) -> "DecisionJournal":
        """Bind the live policy + models (called at attach time).  The
        policy must be stateless (expose ``cascade``); rotation policies
        take the object fallback and are never journaled."""
        self.policy_name = policy.name
        self.params = dict(policy.cascade_params())
        self._cascade = type(policy).cascade
        self.perf = perf
        self.placement = placement
        return self

    @property
    def n(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    # ----------------------------------------------------------- growth --
    def _grow_rows(self, need: int):
        cap = max(self._t.size * 2, need)
        n, P = self._n, self._pmax
        for name in _1D:
            a = getattr(self, name)
            b = np.empty(cap, a.dtype)
            b[:n] = a[:n]
            setattr(self, name, b)
        for name, a in self._f2.items():
            b = np.full((cap, P), np.nan)
            b[:n] = a[:n]
            self._f2[name] = b
        b = np.zeros((cap, P), bool)
        b[:n] = self._alive[:n]
        self._alive = b
        b = np.full((cap, P), KILL_PAD, np.uint8)
        b[:n] = self._kill[:n]
        self._kill = b

    def _grow_width(self, P: int):
        cap, n = self._t.size, self._n
        for name, a in self._f2.items():
            b = np.full((cap, P), np.nan)
            b[:n, :self._pmax] = a[:n]
            self._f2[name] = b
        b = np.zeros((cap, P), bool)
        b[:n, :self._pmax] = self._alive[:n]
        self._alive = b
        b = np.full((cap, P), KILL_PAD, np.uint8)
        b[:n, :self._pmax] = self._kill[:n]
        self._kill = b
        self._pmax = P

    # ----------------------------------------------------------- record --
    def record(self, t: float, fns: Sequence, snap, choice: np.ndarray,
               ok: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Journal one fused decision burst: ``F = len(fns)`` rows,
        ``choice``/``ok`` straight from ``Policy.fn_decisions`` (so the
        journaled choice IS the routing decision, whatever backend made
        it), ``counts[g]`` the number of invocations routed by row
        ``g``.  Returns the journal row ids, one per function group.

        Append-only: no cascade runs here — the feature matrices are
        already in the snapshot's per-function cache (``fn_decisions``
        computed them), so this is interning plus column writes."""
        F, P = len(fns), snap.n
        feats = decision_features(fns, snap, self.perf, self.placement)

        key = tuple(snap.names)
        pid = self._pset_ids.get(key)
        if pid is None:
            pid = len(self.pset_names)
            self._pset_ids[key] = pid
            self.pset_names.append(key)

        need = self._n + F
        if need > self._t.size:
            self._grow_rows(need)
        if P > self._pmax:
            self._grow_width(P)
        lo, hi = self._n, need
        self._t[lo:hi] = t
        for g, fn in enumerate(fns):
            name = fn.name
            fid = self._fn_ids.get(name)
            if fid is None:
                fid = len(self.fn_names)
                self._fn_ids[name] = fid
                self.fn_names.append(name)
            self._fn[lo + g] = fid
        self._count[lo:hi] = np.asarray(counts, np.int32)
        self._pset[lo:hi] = pid
        self._choice[lo:hi] = np.where(np.asarray(ok), np.asarray(choice),
                                       -1).astype(np.int16)
        self._slo_s[lo:hi] = feats["slo_s"]
        for name in FEATURE_COLS:
            self._f2[name][lo:hi, :P] = feats[name]  # (P,) rows broadcast
        self._alive[lo:hi, :P] = feats["alive"]
        self._n = need
        return np.arange(lo, hi, dtype=np.int64)

    # ------------------------------------------------- derived columns --
    def _derive(self):
        """Fill kill/runner/margin for rows appended since the last
        read: one vectorized cascade re-run per platform set — a pure
        function of the journaled features, so the result is identical
        to (and far cheaper than) computing it per recorded burst."""
        lo, n = self._derived_n, self._n
        if lo == n:
            return
        pset = self._pset[lo:n]
        for pid in np.unique(pset):
            P = len(self.pset_names[int(pid)])
            sel = np.nonzero(pset == pid)[0] + lo
            feats = {name: self._f2[name][sel, :P]
                     for name in FEATURE_COLS}
            feats["alive"] = self._alive[sel, :P]
            feats["slo_s"] = self._slo_s[sel]
            cost, kill = self._cascade(feats, self.params)
            masked = np.where((kill == 0) & np.isfinite(cost), cost,
                              np.inf)
            ch = self._choice[sel]
            rest = masked.copy()
            rr = np.nonzero(ch >= 0)[0]
            rest[rr, ch[rr]] = np.inf
            best2 = rest.min(axis=1) if P else \
                np.full(sel.size, np.inf)
            has2 = np.isfinite(best2)
            runner = np.where(has2, np.argmin(rest, axis=1), -1) \
                .astype(np.int16)
            chosen = masked[np.arange(sel.size), np.maximum(ch, 0)]
            self._runner[sel] = runner
            self._margin[sel] = np.where(has2 & (ch >= 0),
                                         best2 - chosen, np.inf)
            self._kill[sel, :P] = kill
            if P < self._pmax:
                self._kill[sel, P:] = KILL_PAD
        self._derived_n = n

    # ---------------------------------------------------------- columns --
    def columns(self) -> Dict[str, np.ndarray]:
        """Trimmed views (not copies) of the journal columns."""
        self._derive()
        n = self._n
        out = {"t": self._t[:n], "fn": self._fn[:n],
               "count": self._count[:n], "pset": self._pset[:n],
               "choice": self._choice[:n], "runner": self._runner[:n],
               "margin": self._margin[:n], "slo_s": self._slo_s[:n],
               "alive": self._alive[:n], "kill": self._kill[:n]}
        for name in FEATURE_COLS:
            out[name] = self._f2[name][:n]
        return out

    def platform_of(self, row: int) -> Optional[str]:
        """Chosen platform name for one journal row (None if infeasible)."""
        ch = int(self._choice[row])
        if ch < 0:
            return None
        return self.pset_names[int(self._pset[row])][ch]

    # ------------------------------------------------------ persistence --
    def save(self, path: str):
        """Write the journal as a .npz archive (CI artifact / offline
        analysis).  ``load_journal`` round-trips it."""
        cols = self.columns()
        meta = {"policy": self.policy_name, "params": self.params,
                "fn_names": self.fn_names,
                "pset_names": [list(p) for p in self.pset_names]}
        np.savez(path, meta=np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), np.uint8), **cols)


def load_journal(path: str) -> DecisionJournal:
    """Rebuild a (read-only) ``DecisionJournal`` from ``save`` output.
    The perf/placement/cascade bindings are not restored — replay takes
    the policy explicitly (or from ``policy_name``/``params``)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        j = DecisionJournal(capacity=max(int(z["t"].size), 1))
        n = int(z["t"].size)
        j._n = n
        j._pmax = int(z["kill"].shape[1]) if z["kill"].ndim == 2 else 0
        j._t[:n] = z["t"]
        j._fn[:n] = z["fn"]
        j._count[:n] = z["count"]
        j._pset[:n] = z["pset"]
        j._choice[:n] = z["choice"]
        j._runner[:n] = z["runner"]
        j._margin[:n] = z["margin"]
        j._slo_s[:n] = z["slo_s"]
        j._alive = np.asarray(z["alive"], bool).reshape(n, j._pmax)
        j._kill = np.asarray(z["kill"], np.uint8).reshape(n, j._pmax)
        j._f2 = {name: np.asarray(z[name]).reshape(n, j._pmax)
                 for name in FEATURE_COLS}
        j._derived_n = n           # save() derived before writing
    j.policy_name = meta["policy"]
    j.params = dict(meta["params"])
    j.fn_names = list(meta["fn_names"])
    j._fn_ids = {f: i for i, f in enumerate(j.fn_names)}
    j.pset_names = [tuple(p) for p in meta["pset_names"]]
    j._pset_ids = {p: i for i, p in enumerate(j.pset_names)}
    return j


# ---------------------------------------------------------------------------
# Calibration analyzer: journal rows x sink completions
# ---------------------------------------------------------------------------

def _stats(a: np.ndarray) -> Dict[str, float]:
    if a.size == 0:
        return {"count": 0, "mean_s": float("nan"), "p90_s": float("nan")}
    return {"count": int(a.size), "mean_s": float(a.mean()),
            "p90_s": float(np.percentile(a, 90.0))}


def decision_provenance_section(journal: DecisionJournal,
                                cols: Dict) -> Dict:
    """The ``decision_provenance`` section of ``ScenarioReport``: the
    vectorized join of journal rows to sink completion columns via the
    stamped ``decision`` row ids.

    * ``calibration``: per-(function, platform) predicted-vs-realized
      exec-latency error (mean abs/rel, signed bias) — how good the perf
      model that drove routing actually was.
    * ``kill_counts``: invocation-weighted per-filter candidate kills.
    * ``regret``: realized response minus the best *feasible alternative*
      latency estimate (exec + data of the best non-chosen candidate) —
      positive regret marks decisions a different feasible platform
      would (per the model) have served faster.
    * ``churn``: per-function rate of consecutive decisions switching
      platform.
    """
    n = journal.n
    jc = journal.columns()
    kill, counts = jc["kill"], jc["count"]
    real = ~np.equal(kill, KILL_PAD)
    killed = {}
    for bit, name in KILL_NAMES.items():
        hit = ((kill & bit) != 0) & real
        killed[name] = int((hit.sum(axis=1) * counts).sum()) if n else 0

    fin = np.isfinite(jc["margin"])
    margin = {"mean_s": float(jc["margin"][fin].mean())
              if fin.any() else float("nan"),
              "p90_s": float(np.percentile(jc["margin"][fin], 90.0))
              if fin.any() else float("nan"),
              "no_runner_up": int(n - fin.sum())}

    # churn: consecutive same-function decisions switching platform
    churn: Dict[str, float] = {}
    switches = transitions = 0
    for fid, fname in enumerate(journal.fn_names):
        rows = np.nonzero(jc["fn"] == fid)[0]
        if rows.size < 2:
            churn[fname] = 0.0
            continue
        key = jc["pset"][rows].astype(np.int64) * 1024 + jc["choice"][rows]
        ch = int(np.count_nonzero(key[1:] != key[:-1]))
        churn[fname] = ch / (rows.size - 1)
        switches += ch
        transitions += rows.size - 1

    # ---- join to completions over the stamped decision row ids --------
    d = np.asarray(cols.get("decision", np.empty(0, np.int64)))
    valid = (d >= 0) & (d < n)
    rows = d[valid]
    ch = jc["choice"][rows]
    good = ch >= 0
    rows, ch = rows[good], ch[good]
    matched = int(rows.size)
    ridx = np.arange(d.size)[valid][good]

    calibration: Dict[str, Dict[str, Dict[str, float]]] = {}
    regret = _stats(np.empty(0))
    regret["positive_rate"] = float("nan")
    if matched:
        pred_exec = jc["exec_s"][rows, ch]
        real_exec = np.asarray(cols["exec"])[ridx]
        err = pred_exec - real_exec
        fkey = jc["fn"][rows]
        pkey = jc["pset"][rows].astype(np.int64) * 1024 + ch
        for pk in np.unique(pkey):
            pname = journal.pset_names[int(pk) // 1024][int(pk) % 1024]
            psel = pkey == pk
            for fk in np.unique(fkey[psel]):
                sel = psel & (fkey == fk)
                e, r = err[sel], real_exec[sel]
                fname = journal.fn_names[int(fk)]
                calibration.setdefault(fname, {})[pname] = {
                    "count": int(sel.sum()),
                    "predicted_mean_s": float(pred_exec[sel].mean()),
                    "realized_mean_s": float(r.mean()),
                    "mean_abs_err_s": float(np.abs(e).mean()),
                    "mean_rel_err": float(
                        (np.abs(e) / np.maximum(r, 1e-9)).mean()),
                    "bias_s": float(e.mean()),
                }
        # regret vs the best feasible *alternative* estimate
        est = jc["exec_s"][rows] + jc["data_s"][rows]
        feasible = np.equal(jc["kill"][rows], 0)
        alt = np.where(feasible, est, np.inf)
        alt[np.arange(rows.size), ch] = np.inf
        best_alt = alt.min(axis=1)
        has_alt = np.isfinite(best_alt)
        resp = (np.asarray(cols["end"]) - np.asarray(cols["arrival"]))[ridx]
        reg = resp[has_alt] - best_alt[has_alt]
        regret = _stats(reg)
        regret["positive_rate"] = \
            float((reg > 0).mean()) if reg.size else float("nan")

    return {
        "policy": journal.policy_name,
        "params": {k: float(v) for k, v in sorted(journal.params.items())},
        "decisions": int(n),
        "invocations": int(counts.sum()) if n else 0,
        "matched_completions": matched,
        "infeasible_decisions": int((jc["choice"] < 0).sum()) if n else 0,
        "kill_counts": killed,
        "margin": margin,
        "churn": {"per_fn": churn,
                  "overall": (switches / transitions) if transitions
                  else 0.0},
        "calibration": calibration,
        "regret": regret,
    }
