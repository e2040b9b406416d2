"""Per-tenant QoS and overload resilience (paper §SLO / §energy
objectives): the FDaaS objective is scheduling functions to *meet SLO
requirements*, which best-effort FIFO cannot do once arrival rate
exceeds capacity — someone must lose, and the operator should choose
who.  This module makes that choice explicit with three ingredients:

  * **QoS classes** — ``latency_critical`` / ``standard`` / ``batch``
    ride every invocation as an int8 column (tenant as int32), so the
    columnar admission path stays array-native.  Per-class SLO
    multipliers tighten or relax each class's effective deadline.
  * **Deficit round robin** (Shreedhar & Varghese) at each platform
    queue: classes drain in weight proportion instead of pure FIFO, so
    a batch flood cannot starve latency-critical traffic.  The drain is
    vectorized — one ``np.lexsort`` over (round, class-rank) per drain,
    with DRR state in preallocated int64 arrays — and parity-tested
    against the scalar reference below.  Weights are *integers* and
    deficits int64 on purpose: integer arithmetic makes the closed-form
    plan bit-identical to the sequential loop (repeated float addition
    rounds differently than multiplication at quantum boundaries).
  * **Admission control** at the gateway: per-class token buckets,
    load-shedding on queue-depth / telemetry burn-rate signals with a
    shed-vs-degrade-vs-spillover policy knob, and a *brownout* mode
    where an energy cap (paper §energy objective) degrades batch-class
    service first.

FIFO recovery is exact and structural: with uniform weights the
platform never builds per-class queues at all (``QosSpec.drr_enabled``
is False), so the qos-off fast paths — and their goldens — are
untouched byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "QOS_LATENCY_CRITICAL", "QOS_STANDARD", "QOS_BATCH", "N_QOS",
    "QOS_NAMES", "DEFAULT_QOS", "DEFAULT_TENANT", "qos_id", "QosSpec",
    "drr_drain_scalar", "drr_plan", "drr_commit", "TokenBuckets",
    "AdmissionController",
]

QOS_LATENCY_CRITICAL = 0
QOS_STANDARD = 1
QOS_BATCH = 2
N_QOS = 3
QOS_NAMES = ("latency_critical", "standard", "batch")
DEFAULT_QOS = QOS_STANDARD
DEFAULT_TENANT = 0

OVERLOAD_ACTIONS = ("shed", "degrade", "spillover")


def qos_id(cls) -> int:
    """Class name or id -> id (class rank: lower drains first per round)."""
    if isinstance(cls, str):
        try:
            return QOS_NAMES.index(cls)
        except ValueError:
            raise ValueError(f"unknown QoS class {cls!r}; "
                             f"one of {QOS_NAMES}") from None
    c = int(cls)
    if not 0 <= c < N_QOS:
        raise ValueError(f"QoS class id {c} out of range 0..{N_QOS - 1}")
    return c


@dataclass(frozen=True)
class QosSpec:
    """The QoS layer's knobs, in class order (latency_critical,
    standard, batch).  ``weights`` are integer DRR quanta (rows per
    round); uniform weights disable DRR entirely — exact FIFO, zero
    hot-path cost.  ``rate_limits`` (req/s per class, None = unlimited)
    arms per-class token buckets; ``shed_queue_depth`` arms overload
    handling (batch sheds at the threshold, standard too beyond
    ``shed_hard_factor`` times it; latency_critical is never
    overload-shed); ``overload_action`` picks what "handling" means:
    drop ("shed"), demote standard to batch class ("degrade" — they
    run, deprioritized, keeping their original deadline), or reroute
    low classes to the least-loaded platform ("spillover").
    ``burn_threshold`` adds a telemetry signal: shed when the trailing
    ``burn_window_s`` error-budget burn rate (vs ``burn_slo_target``)
    crosses it.  ``energy_cap_w`` arms brownout: when fleet power
    exceeds the cap, batch-class arrivals shed first (§energy
    objective)."""

    weights: Tuple[int, ...] = (4, 2, 1)
    slo_multipliers: Tuple[float, ...] = (0.5, 1.0, 4.0)
    rate_limits: Optional[Tuple[Optional[float], ...]] = None
    burst: Tuple[float, ...] = (256.0, 256.0, 256.0)
    shed_queue_depth: Optional[float] = None
    shed_hard_factor: float = 2.0
    overload_action: str = "shed"
    burn_threshold: Optional[float] = None
    burn_window_s: float = 30.0
    burn_slo_target: float = 0.99
    signal_interval_s: float = 1.0
    energy_cap_w: Optional[float] = None

    def __post_init__(self):
        for name in ("weights", "slo_multipliers", "burst"):
            v = getattr(self, name)
            if len(v) != N_QOS:
                raise ValueError(f"{name} needs {N_QOS} entries, got {v!r}")
        if any(int(w) != w or w < 1 for w in self.weights):
            raise ValueError(f"DRR weights must be integers >= 1 "
                             f"(got {self.weights!r}): integer quanta keep "
                             f"the vectorized plan exact vs the scalar "
                             f"reference")
        object.__setattr__(self, "weights",
                           tuple(int(w) for w in self.weights))
        if self.overload_action not in OVERLOAD_ACTIONS:
            raise ValueError(f"overload_action must be one of "
                             f"{OVERLOAD_ACTIONS}, "
                             f"got {self.overload_action!r}")
        if self.rate_limits is not None and \
                len(self.rate_limits) != N_QOS:
            raise ValueError(f"rate_limits needs {N_QOS} entries")

    def uniform_weights(self) -> bool:
        return len(set(self.weights)) == 1

    def drr_enabled(self) -> bool:
        """Non-uniform weights only: uniform DRR *is* FIFO (every class
        gets one quantum per round), so the platform keeps its single
        FIFO deque — the documented exact-recovery specialization."""
        return not self.uniform_weights()

    def to_dict(self) -> Dict:
        return {
            "weights": list(self.weights),
            "slo_multipliers": list(self.slo_multipliers),
            "rate_limits": (None if self.rate_limits is None
                            else list(self.rate_limits)),
            "burst": list(self.burst),
            "shed_queue_depth": self.shed_queue_depth,
            "shed_hard_factor": self.shed_hard_factor,
            "overload_action": self.overload_action,
            "burn_threshold": self.burn_threshold,
            "burn_window_s": self.burn_window_s,
            "burn_slo_target": self.burn_slo_target,
            "signal_interval_s": self.signal_interval_s,
            "energy_cap_w": self.energy_cap_w,
        }

    @staticmethod
    def from_dict(d: Dict) -> "QosSpec":
        keys = {f for f in QosSpec.__dataclass_fields__}  # type: ignore
        kw = {k: v for k, v in d.items() if k in keys}
        for name in ("weights", "slo_multipliers", "burst", "rate_limits"):
            if kw.get(name) is not None:
                kw[name] = tuple(kw[name])
        return QosSpec(**kw)


# ------------------------------------------------------------------ DRR ---
def drr_drain_scalar(backlogs: Sequence[int], deficits: Sequence[int],
                     weights: Sequence[int], capacity: int
                     ) -> Tuple[List[int], List[int]]:
    """Reference deficit-round-robin drain: serve up to ``capacity``
    rows from per-class backlogs, visiting classes in rank order each
    round, crediting each non-empty class its weight quantum per round.
    Returns (class id per served row, final deficits).  A class that
    fully drains (or arrives empty) resets its deficit — standard DRR:
    credit does not accrue while a queue is empty.  This is the oracle
    the vectorized ``drr_plan`` / ``drr_commit`` pair is parity-tested
    against."""
    n = len(backlogs)
    rem = [int(b) for b in backlogs]
    d = [int(x) for x in deficits]
    w = [int(x) for x in weights]
    for c in range(n):
        if rem[c] == 0:
            d[c] = 0
    order: List[int] = []
    cap = int(capacity)
    while cap > 0 and any(rem):
        for c in range(n):
            if rem[c] == 0:
                continue
            d[c] += w[c]
            take = min(d[c], rem[c], cap)
            order.extend([c] * take)
            d[c] -= take
            rem[c] -= take
            cap -= take
            if rem[c] == 0:
                d[c] = 0
            if cap == 0:
                break
    return order, d


def drr_plan(backlogs: np.ndarray, deficits: np.ndarray,
             weights: np.ndarray, capacity: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized DRR serve order, closed form: row ``k`` (1-indexed)
    of class ``c`` is served in round ``max(1, ceil((k - d0_c)/w_c))``,
    and the global order is one stable ``np.lexsort`` keyed (round,
    class rank) — stability preserves FIFO within a class.  Only
    ``min(backlog_c, capacity + 1)`` candidate rows per class are
    planned (the +1 keeps the first *blocked* row in-plan, so a drain
    that stops early still knows where it stopped).  Returns
    (class id, round) per planned row, in serve order."""
    backlogs = np.asarray(backlogs, dtype=np.int64)
    deficits = np.asarray(deficits, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.int64)
    cand = np.minimum(backlogs, capacity + 1)
    total = int(cand.sum())
    if total == 0:
        empty = np.empty(0, np.int64)
        return empty, empty
    cls = np.repeat(np.arange(len(cand), dtype=np.int64), cand)
    offs = np.cumsum(cand) - cand
    k = np.arange(1, total + 1, dtype=np.int64) - np.repeat(offs, cand)
    rounds = -(-(k - deficits[cls]) // weights[cls])
    np.maximum(rounds, 1, out=rounds)
    order = np.lexsort((cls, rounds))
    return cls[order], rounds[order]


def drr_commit(deficits: np.ndarray, weights: np.ndarray,
               backlogs: np.ndarray, served: Sequence[int],
               plan_cls: np.ndarray, plan_rounds: np.ndarray,
               n_served: int) -> np.ndarray:
    """Final deficits after serving the first ``n_served`` plan rows —
    exactly what the scalar loop would leave with capacity ==
    ``n_served``.  Credited rounds follow from the LAST SERVED row
    (round ``rb``, class ``cb``): classes ranked at-or-before ``cb``
    received their round-``rb`` quantum, later-ranked classes only
    rounds ``1..rb-1`` (the scalar loop breaks inside ``cb``'s visit
    the moment capacity hits zero, before crediting anyone after it).
    Classes that fully drained — or were empty — reset to 0."""
    deficits = np.asarray(deficits, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.int64)
    backlogs = np.asarray(backlogs, dtype=np.int64)
    served = np.asarray(served, dtype=np.int64)
    new = deficits.copy()
    if n_served > 0:
        rb = int(plan_rounds[n_served - 1])
        cb = int(plan_cls[n_served - 1])
        credited = np.where(np.arange(len(new)) <= cb, rb, rb - 1)
        active = (backlogs > 0) & (served < backlogs)
        new = np.where(active,
                       deficits + credited * weights - served,
                       0).astype(np.int64)
    else:
        new[backlogs == 0] = 0
    return new


# -------------------------------------------------------- token buckets ---
class TokenBuckets:
    """Per-class token buckets, refilled lazily in one vectorized step.
    ``None`` rate entries mean unlimited for that class."""

    __slots__ = ("rates", "caps", "tokens", "last_t", "limited")

    def __init__(self, rates: Sequence[Optional[float]],
                 burst: Sequence[float]):
        self.limited = np.array([r is not None for r in rates])
        self.rates = np.array([0.0 if r is None else float(r)
                               for r in rates])
        self.caps = np.asarray(burst, dtype=np.float64)
        self.tokens = self.caps.copy()
        self.last_t = 0.0

    def take(self, counts: np.ndarray, now: float) -> np.ndarray:
        """Admit up to ``counts`` per class; returns the admitted
        counts.  Refill is rate * elapsed, clipped at burst."""
        dt = now - self.last_t
        if dt > 0.0:
            np.minimum(self.caps, self.tokens + self.rates * dt,
                       out=self.tokens)
            self.last_t = now
        allowed = np.minimum(counts,
                             np.floor(self.tokens)).astype(np.int64)
        np.maximum(allowed, 0, out=allowed)
        allowed = np.where(self.limited, allowed, counts)
        self.tokens -= np.where(self.limited, allowed, 0)
        return allowed


# --------------------------------------------------- admission control ----
class AdmissionController:
    """The gate inside the control plane's unified ``admit()`` core:
    token buckets -> overload action (shed / degrade / spillover) ->
    brownout, each acting on whatever the previous stage let through.
    Ingress-shed rows never reach the behavioral models — they are
    dropped before the control plane "sees" them, exactly like a
    gateway 429.  All counters live here and feed the ScenarioReport
    ``qos`` section."""

    def __init__(self, spec: QosSpec, clock):
        self.spec = spec
        self.clock = clock
        self.buckets = (TokenBuckets(spec.rate_limits, spec.burst)
                        if spec.rate_limits is not None else None)
        mults = np.asarray(spec.slo_multipliers, dtype=np.float64)
        # identity multipliers skip the per-burst column write entirely
        self._mults = None if np.all(mults == 1.0) else mults
        self.token_shed = np.zeros(N_QOS, np.int64)
        self.overload_shed = np.zeros(N_QOS, np.int64)
        self.brownout_shed = np.zeros(N_QOS, np.int64)
        self.shed_by_tenant: Dict[int, int] = {}
        self.degraded = 0
        self.spilled = 0
        self.overload_events = 0
        self.brownout_events = 0
        self._sig_t = -np.inf         # cached burn-rate signal
        self._sig_over = False

    # ------------------------------------------------------- signals ------
    def _queue_depth(self, cp) -> float:
        depth = 0
        for p in cp.platforms.values():
            if not p.failed:
                depth += p.queued_rows
        return float(depth)

    def _burn_over(self, cp, now: float) -> bool:
        """Trailing-window error-budget burn from the telemetry rollups
        (PR-8 engine), cached at ``signal_interval_s`` so the gate never
        walks rollup buckets more than once per sim-second."""
        eng = cp.telemetry
        if eng is None:
            return False
        if now - self._sig_t < self.spec.signal_interval_s:
            return self._sig_over
        self._sig_t = now
        eng.flush()
        tier_s = float(eng.cfg.tiers_s[0])
        w = max(1, int(round(self.spec.burn_window_s / tier_s)))
        cutoff = int(now // tier_s) - w
        tot = 0.0
        bad = 0.0
        for (_p, _f, m), sr in eng.series.items():
            if m != "response_time":
                continue
            ids, counts, _sums, _mins, _maxs, badv, _q = sr.series(0)
            if not len(ids):
                continue
            sel = ids >= cutoff
            tot += float(counts[sel].sum())
            bad += float(badv[sel].sum())
        budget = max(1.0 - self.spec.burn_slo_target, 1e-9)
        burn = (bad / tot / budget) if tot else 0.0
        self._sig_over = burn >= self.spec.burn_threshold
        return self._sig_over

    def _spill_target(self, cp, fn_counts=()) -> Optional[str]:
        """Spill destination respecting data gravity: platforms are
        scored by the mean per-invocation transfer seconds the spilled
        functions' data objects would cost from each candidate
        (``DataPlacementManager.access_time`` — the same seconds-per-byte
        accounting the chains planner uses) plus a normalized load term
        (queued rows + busy replicas per total replica).  A platform
        already holding the hot objects therefore beats a marginally
        less-loaded one that would pull every byte over the WAN.

        ``fn_counts`` is a sequence of ``(FunctionSpec, count)`` for the
        rows being spilled; empty falls back to pure least-load (name as
        the deterministic tie-break either way)."""
        placement = getattr(cp, "placement", None)
        total = sum(c for _fn, c in fn_counts)
        best = None
        for name, p in cp.platforms.items():
            if p.failed:
                continue
            load = (p.queued_rows + p.busy_replicas()) / \
                max(p.prof.total_replicas, 1)
            transfer = 0.0
            if total and placement is not None:
                for fn, c in fn_counts:
                    for obj in fn.data_objects:
                        transfer += c * placement.access_time(obj, name)
                transfer /= total
            score = transfer + load
            if best is None or (score, name) < best:
                best = (score, name)
        return None if best is None else best[1]

    def _fleet_power_w(self, cp) -> float:
        return sum(cp.energy.power_w(name, p.cpu_util())
                   for name, p in cp.platforms.items() if not p.failed)

    # ---------------------------------------------------- shed plumbing ---
    def _tally_tenants(self, tenants: np.ndarray):
        counts = np.bincount(tenants)
        for t in np.nonzero(counts)[0]:
            t = int(t)
            self.shed_by_tenant[t] = \
                self.shed_by_tenant.get(t, 0) + int(counts[t])

    def _reject_columns(self, cp, batch, rows: np.ndarray, now: float):
        """Mirror of the admission paths' reject idiom: REJECTED state,
        rejected counter, retained materialized rows, per-fn recorder
        rejects."""
        batch.state[rows] = batch.REJECTED
        cp.rejected_count += int(rows.size)
        if cp.retain_completions:
            for i in rows:
                inv = batch.materialize(int(i))
                inv.status = "failed"
                cp.rejected.append(inv)
        self._tally_tenants(batch.tenant[rows])
        rec = cp.recorder
        if rec is not None:
            counts = np.bincount(batch.fn_idx[rows],
                                 minlength=len(batch.specs))
            for j in np.nonzero(counts)[0]:
                rec.record_reject(batch.specs[int(j)].name, None, now,
                                  int(counts[j]))

    def _reject_objects(self, cp, invs: List, now: float):
        rec = cp.recorder
        fn_counts: Dict[str, int] = {}
        for inv in invs:
            inv.status = "failed"
            cp._reject(inv)
            self.shed_by_tenant[inv.tenant] = \
                self.shed_by_tenant.get(inv.tenant, 0) + 1
            if rec is not None:
                name = inv.fn.name
                fn_counts[name] = fn_counts.get(name, 0) + 1
        if rec is not None:
            for name, c in fn_counts.items():
                rec.record_reject(name, None, now, c)

    # ------------------------------------------------------ gate: batch ---
    def gate_columns(self, cp, batch):
        """Gate one columnar burst.  Returns ``(kept, spill)`` where
        ``kept`` is the surviving batch (the original, a filtered copy,
        or None) and ``spill`` is ``(invocations, platform_name)`` to
        admit after the main rows, or None."""
        spec = self.spec
        now = self.clock.now()
        qcol = batch.qos
        n = batch.n
        if self._mults is not None:
            # effective per-class deadline: columnar-only metadata (the
            # report derives class-adjusted violations from the spec)
            batch.deadline_s *= self._mults[qcol]
        keep: Optional[np.ndarray] = None
        # 1. per-class token buckets (tail rows beyond allowance shed)
        if self.buckets is not None:
            counts = np.bincount(qcol, minlength=N_QOS)
            allowed = self.buckets.take(counts, now)
            short = np.nonzero(allowed < counts)[0]
            if short.size:
                keep = np.ones(n, bool)
                for c in short:
                    rows = np.nonzero(qcol == np.int8(c))[0]
                    drop = rows[int(allowed[c]):]
                    keep[drop] = False
                    self.token_shed[c] += drop.size
                self._reject_columns(cp, batch, np.nonzero(~keep)[0], now)
        # 2. overload action over the survivors
        spill = None
        over = hard = False
        if spec.shed_queue_depth is not None:
            depth = self._queue_depth(cp)
            over = depth >= spec.shed_queue_depth
            hard = depth >= spec.shed_queue_depth * spec.shed_hard_factor
        if not over and spec.burn_threshold is not None:
            over = self._burn_over(cp, now)
        if over:
            self.overload_events += 1
            kept = keep if keep is not None else np.ones(n, bool)
            if spec.overload_action == "degrade":
                sel = kept & (qcol == np.int8(QOS_STANDARD))
                dn = int(np.count_nonzero(sel))
                if dn:
                    qcol[sel] = QOS_BATCH
                    self.degraded += dn
            else:
                low = kept & (qcol == np.int8(QOS_BATCH))
                if hard:
                    low |= kept & (qcol == np.int8(QOS_STANDARD))
                rows = np.nonzero(low)[0]
                target = None
                if spec.overload_action == "spillover" and rows.size:
                    counts = np.bincount(batch.fn_idx[rows],
                                         minlength=len(batch.specs))
                    fc = [(batch.specs[int(j)], int(counts[j]))
                          for j in np.nonzero(counts)[0]]
                    target = self._spill_target(cp, fc)
                if rows.size and target is not None:
                    kept[rows] = False
                    keep = kept
                    spill_invs = []
                    for i in rows:
                        i = int(i)
                        inv = batch.materialize(i)
                        batch.state[i] = batch.ADMITTED
                        spill_invs.append(inv)
                    self.spilled += rows.size
                    spill = (spill_invs, target)
                elif rows.size:          # shed (or nowhere to spill)
                    kept[rows] = False
                    keep = kept
                    sc = np.bincount(qcol[rows], minlength=N_QOS)
                    self.overload_shed += sc
                    self._reject_columns(cp, batch, rows, now)
        # 3. brownout: fleet power above the energy cap sheds batch
        if spec.energy_cap_w is not None and \
                self._fleet_power_w(cp) > spec.energy_cap_w:
            kept = keep if keep is not None else np.ones(n, bool)
            rows = np.nonzero(kept & (qcol == np.int8(QOS_BATCH)))[0]
            if rows.size:
                self.brownout_events += 1
                kept[rows] = False
                keep = kept
                self.brownout_shed[QOS_BATCH] += rows.size
                self._reject_columns(cp, batch, rows, now)
        if keep is None:
            return batch, spill
        kept_idx = np.nonzero(keep)[0]
        if kept_idx.size == n:
            return batch, spill
        if kept_idx.size == 0:
            return None, spill
        sub = type(batch)(batch.specs, batch.fn_idx[kept_idx],
                          batch.arrival_t[kept_idx],
                          batch.payload_bytes[kept_idx],
                          batch.deadline_s[kept_idx],
                          batch.state[kept_idx],
                          qos=batch.qos[kept_idx],
                          tenant=batch.tenant[kept_idx],
                          decision=batch.decision[kept_idx])
        return sub, spill

    # ----------------------------------------------------- gate: objects --
    def gate_objects(self, cp, invs):
        """Object-path twin of ``gate_columns`` (same stages, same
        counters) over a sequence of ``Invocation`` objects."""
        spec = self.spec
        now = self.clock.now()
        kept = list(invs)
        # 1. token buckets
        if self.buckets is not None:
            counts = np.zeros(N_QOS, np.int64)
            for inv in kept:
                counts[inv.qos] += 1
            allowed = self.buckets.take(counts, now)
            if (allowed < counts).any():
                left = allowed.copy()
                admit, shed = [], []
                for inv in kept:
                    if left[inv.qos] > 0:
                        left[inv.qos] -= 1
                        admit.append(inv)
                    else:
                        shed.append(inv)
                        self.token_shed[inv.qos] += 1
                kept = admit
                self._reject_objects(cp, shed, now)
        # 2. overload action
        spill = None
        over = hard = False
        if spec.shed_queue_depth is not None:
            depth = self._queue_depth(cp)
            over = depth >= spec.shed_queue_depth
            hard = depth >= spec.shed_queue_depth * spec.shed_hard_factor
        if not over and spec.burn_threshold is not None:
            over = self._burn_over(cp, now)
        if over and kept:
            self.overload_events += 1
            if spec.overload_action == "degrade":
                for inv in kept:
                    if inv.qos == QOS_STANDARD:
                        inv.qos = QOS_BATCH
                        self.degraded += 1
            else:
                low_classes = {QOS_BATCH, QOS_STANDARD} if hard \
                    else {QOS_BATCH}
                low = [inv for inv in kept if inv.qos in low_classes]
                if low:
                    target = None
                    if spec.overload_action == "spillover":
                        groups: Dict[int, List] = {}
                        for inv in low:
                            g = groups.get(id(inv.fn))
                            if g is None:
                                groups[id(inv.fn)] = [inv.fn, 1]
                            else:
                                g[1] += 1
                        target = self._spill_target(
                            cp, [(fn, c) for fn, c in groups.values()])
                    kept = [inv for inv in kept
                            if inv.qos not in low_classes]
                    if target is not None:
                        self.spilled += len(low)
                        spill = (low, target)
                    else:
                        for inv in low:
                            self.overload_shed[inv.qos] += 1
                        self._reject_objects(cp, low, now)
        # 3. brownout
        if spec.energy_cap_w is not None and kept and \
                self._fleet_power_w(cp) > spec.energy_cap_w:
            low = [inv for inv in kept if inv.qos == QOS_BATCH]
            if low:
                self.brownout_events += 1
                kept = [inv for inv in kept if inv.qos != QOS_BATCH]
                self.brownout_shed[QOS_BATCH] += len(low)
                self._reject_objects(cp, low, now)
        return kept, spill

    # ------------------------------------------------------- reporting ----
    def section(self) -> Dict:
        """The admission fragment of the ScenarioReport ``qos`` section."""
        def per_class(a: np.ndarray) -> Dict[str, int]:
            return {QOS_NAMES[c]: int(a[c]) for c in range(N_QOS)}
        total = self.token_shed + self.overload_shed + self.brownout_shed
        return {
            "shed_total": int(total.sum()),
            "shed_by_class": per_class(total),
            "token_shed": per_class(self.token_shed),
            "overload_shed": per_class(self.overload_shed),
            "brownout_shed": per_class(self.brownout_shed),
            "shed_by_tenant": {str(t): int(c) for t, c in
                               sorted(self.shed_by_tenant.items())},
            "degraded": int(self.degraded),
            "spilled": int(self.spilled),
            "overload_events": int(self.overload_events),
            "brownout_events": int(self.brownout_events),
        }
