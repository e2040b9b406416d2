"""Behavioral Modeling (paper §3.3): online-learned models that drive
runtime decisions.

  * ``P2Quantile``        — streaming P90 estimator (P² algorithm), the
                            user-centric SLO signal.
  * ``EWMA``              — exponentially-weighted scalar estimator.
  * ``EventModel``        — invocation-rate tracking + Holt linear forecast;
                            feeds predictive prewarming (cold-start
                            avoidance, §6.1).
  * ``FunctionPerformanceModel`` — per (function, platform) execution time /
                            energy model, updated online; the Scheduler's
                            main input (§3.1.3).
  * ``DataAccessModel``   — object access frequencies per function; feeds
                            data placement (§5.1.4).
  * ``InteractionModel``  — producer/consumer co-invocation graph (§6.3).

The performance model's estimator state is *columnar*: every (function,
platform) EWMA / P² estimator lives in preallocated NumPy arrays
(``PerfState``, grown by doubling), not in dicts of Python objects.  The
scalar ``observe`` path reads one cell into Python floats, runs exactly
the classic update, and writes the cell back — float64 round-trips are
bit-exact, so the columnar state produces byte-identical predictions to
the historical object state.  What the arrays buy is the vectorized
read side: ``predict_matrix`` builds a whole (F, P) prediction block in
one pass, and ``estimator_columns`` exports the raw state the fused
jitted admission step gathers from.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import (FunctionSpec, Invocation,
                                    PlatformProfile, SLO)


class P2Quantile:
    """Jain & Chlamtac's P² streaming quantile estimator."""

    def __init__(self, q: float = 0.9):
        self.q = q
        self._init: List[float] = []
        self.n: Optional[List[int]] = None
        self.ns: Optional[List[float]] = None
        self.heights: Optional[List[float]] = None
        self.count = 0

    def add(self, x: float):
        self.count += 1
        if self.heights is None:
            self._init.append(x)
            if len(self._init) == 5:
                self._init.sort()
                self.heights = list(self._init)
                self.n = [0, 1, 2, 3, 4]
                self.ns = [0, 2 * self.q, 4 * self.q,
                           2 + 2 * self.q, 4]
            return
        _p2_update(self.heights, self.n, self.ns, self.q, x)

    def value(self) -> float:
        if self.heights is None:
            if not self._init:
                return float("nan")
            s = sorted(self._init)
            return s[min(int(self.q * len(s)), len(s) - 1)]
        return self.heights[2]


def _p2_update(h: List[float], n: List[int], ns: List[float],
               q: float, x: float) -> None:
    """One post-bootstrap P² marker update, in place on plain Python
    lists/floats (the shared scalar core of ``P2Quantile`` and the
    columnar cells in ``PerfState`` — identical arithmetic, bit-exact)."""
    if x < h[0]:
        h[0] = x
        k = 0
    elif x >= h[4]:
        h[4] = x
        k = 3
    else:
        k = next(i for i in range(4) if h[i] <= x < h[i + 1])
    for i in range(k + 1, 5):
        n[i] += 1
    for i, d in enumerate((0, q / 2, q, (1 + q) / 2, 1)):
        ns[i] += d
    for i in (1, 2, 3):
        d = ns[i] - n[i]
        if (d >= 1 and n[i + 1] - n[i] > 1) or \
           (d <= -1 and n[i - 1] - n[i] < -1):
            d = 1 if d > 0 else -1
            # parabolic
            hp = h[i] + d / (n[i + 1] - n[i - 1]) * (
                (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) /
                (n[i + 1] - n[i]) +
                (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) /
                (n[i] - n[i - 1]))
            if not h[i - 1] < hp < h[i + 1]:
                hp = h[i] + d * (h[i + d] - h[i]) / (n[i + d] - n[i])
            h[i] = hp
            n[i] += d


class EWMA:
    def __init__(self, alpha: float = 0.2, init: Optional[float] = None):
        self.alpha = alpha
        self.v = init
        self.count = 0

    def add(self, x: float):
        self.count += 1
        self.v = x if self.v is None else \
            self.alpha * x + (1 - self.alpha) * self.v

    def value(self, default: float = float("nan")) -> float:
        return default if self.v is None else self.v


class EventModel:
    """Application Event Model: per-function arrival rate + Holt forecast."""

    def __init__(self, window_s: float = 10.0, alpha: float = 0.5,
                 beta: float = 0.3):
        self.window_s = window_s
        self.alpha, self.beta = alpha, beta
        self._counts: Dict[str, Dict[int, int]] = defaultdict(
            lambda: defaultdict(int))
        self._level: Dict[str, float] = {}
        self._trend: Dict[str, float] = {}
        self._last_w: Dict[str, int] = {}

    def record(self, fn: str, t: float):
        self.record_many(fn, t, 1)

    def record_many(self, fn: str, t: float, count: int = 1):
        """Fold ``count`` simultaneous arrivals (one batch) into the rate
        model — equivalent to ``count`` calls to ``record(fn, t)`` but one
        window update."""
        if count <= 0:
            return
        w = int(t // self.window_s)
        self._counts[fn][w] += count
        lw = self._last_w.get(fn)
        if lw is None:
            self._last_w[fn] = w
            return
        while lw < w:                      # close finished windows
            x = float(self._counts[fn][lw])
            lvl = self._level.get(fn, x)
            tr = self._trend.get(fn, 0.0)
            new_lvl = self.alpha * x + (1 - self.alpha) * (lvl + tr)
            self._trend[fn] = self.beta * (new_lvl - lvl) + \
                (1 - self.beta) * tr
            self._level[fn] = new_lvl
            lw += 1
        self._last_w[fn] = w

    def forecast_rate(self, fn: str, horizon_windows: int = 1) -> float:
        lvl = self._level.get(fn)
        if lvl is None:
            return 0.0
        return max(0.0, (lvl + horizon_windows * self._trend.get(fn, 0.0))
                   / self.window_s)


# ---------------------------------------------------------------------------
# Columnar estimator state
# ---------------------------------------------------------------------------

class QuantileState(NamedTuple):
    """Struct-of-arrays P² state for an (F, P) grid of estimators.

    ``buf`` holds the first five observations per cell (the bootstrap
    window); once a cell's count reaches 5 its ``heights`` / ``pos`` /
    ``want`` markers take over, exactly like ``P2Quantile``."""

    buf: np.ndarray       # (F, P, 5) f8  bootstrap observations
    heights: np.ndarray   # (F, P, 5) f8  marker heights
    pos: np.ndarray       # (F, P, 5) i8  marker positions (n)
    want: np.ndarray      # (F, P, 5) f8  desired positions (n')
    count: np.ndarray     # (F, P)    i8  observations seen

    @staticmethod
    def alloc(nf: int, npl: int) -> "QuantileState":
        return QuantileState(
            np.zeros((nf, npl, 5)), np.zeros((nf, npl, 5)),
            np.zeros((nf, npl, 5), np.int64), np.zeros((nf, npl, 5)),
            np.zeros((nf, npl), np.int64))

    def grown(self, nf: int, npl: int) -> "QuantileState":
        new = QuantileState.alloc(nf, npl)
        f, p = self.count.shape
        for dst, src in zip(new, self):
            dst[:f, :p] = src
        return new


class PerfState(NamedTuple):
    """Preallocated columnar estimator state of the performance model:
    exec-time EWMA, exec/response P² P90s per (function, platform) cell,
    cold-start EWMA per platform."""

    exec_v: np.ndarray    # (F, P) f8  exec EWMA value (NaN until first obs)
    exec_n: np.ndarray    # (F, P) i8  exec EWMA count
    exec_q: QuantileState                    # exec-time P90
    resp_q: QuantileState                    # response-time P90
    cold_v: np.ndarray    # (P,) f8   cold-start EWMA value
    cold_n: np.ndarray    # (P,) i8   cold-start EWMA count

    @staticmethod
    def alloc(nf: int, npl: int) -> "PerfState":
        return PerfState(
            np.full((nf, npl), np.nan), np.zeros((nf, npl), np.int64),
            QuantileState.alloc(nf, npl), QuantileState.alloc(nf, npl),
            np.full(npl, np.nan), np.zeros(npl, np.int64))

    def grown(self, nf: int, npl: int) -> "PerfState":
        new = PerfState.alloc(nf, npl)
        f, p = self.exec_n.shape
        new.exec_v[:f, :p] = self.exec_v
        new.exec_n[:f, :p] = self.exec_n
        new.cold_v[:p] = self.cold_v
        new.cold_n[:p] = self.cold_n
        return new._replace(exec_q=self.exec_q.grown(nf, npl),
                            resp_q=self.resp_q.grown(nf, npl))


def _q_add(qs: QuantileState, fi: int, pi: int, x: float, q: float) -> None:
    """Scalar P² add on one columnar cell — bit-exact ``P2Quantile.add``
    (cells round-trip through float64, which is lossless)."""
    c = int(qs.count[fi, pi])
    qs.count[fi, pi] = c + 1
    if c < 5:
        qs.buf[fi, pi, c] = x
        if c == 4:
            s = sorted(float(v) for v in qs.buf[fi, pi])
            qs.heights[fi, pi] = s
            qs.pos[fi, pi] = (0, 1, 2, 3, 4)
            qs.want[fi, pi] = (0, 2 * q, 4 * q, 2 + 2 * q, 4)
        return
    h = [float(v) for v in qs.heights[fi, pi]]
    n = [int(v) for v in qs.pos[fi, pi]]
    ns = [float(v) for v in qs.want[fi, pi]]
    _p2_update(h, n, ns, q, x)
    qs.heights[fi, pi] = h
    qs.pos[fi, pi] = n
    qs.want[fi, pi] = ns


def _q_value(qs: QuantileState, fi: int, pi: int, q: float) -> float:
    c = int(qs.count[fi, pi])
    if c == 0:
        return float("nan")
    if c < 5:
        s = sorted(float(v) for v in qs.buf[fi, pi, :c])
        return s[min(int(q * c), c - 1)]
    return float(qs.heights[fi, pi, 2])


class _QuantileCell:
    """Live read view of one (function, platform) P² cell — the dict-of-
    ``P2Quantile`` surface (``.count`` / ``.value()``) kept for external
    readers (hedging's observation gate)."""

    __slots__ = ("_model", "_attr", "_fi", "_pi", "q")

    def __init__(self, model: "FunctionPerformanceModel", attr: str,
                 fi: int, pi: int, q: float = 0.9):
        self._model = model
        self._attr = attr
        self._fi, self._pi = fi, pi
        self.q = q

    @property
    def count(self) -> int:
        qs = getattr(self._model._state, self._attr)
        return int(qs.count[self._fi, self._pi])

    def value(self) -> float:
        return _q_value(getattr(self._model._state, self._attr),
                        self._fi, self._pi, self.q)


class _EwmaCell:
    """Live read view of one exec-EWMA cell (``.count`` / ``.value()``)."""

    __slots__ = ("_model", "_fi", "_pi")

    def __init__(self, model: "FunctionPerformanceModel", fi: int, pi: int):
        self._model = model
        self._fi, self._pi = fi, pi

    @property
    def count(self) -> int:
        return int(self._model._state.exec_n[self._fi, self._pi])

    def value(self, default: float = float("nan")) -> float:
        if self.count == 0:
            return default
        return float(self._model._state.exec_v[self._fi, self._pi])


class _PairMap:
    """Read-only mapping facade over the (function, platform) estimator
    grid: ``get((fn_name, platform_name))`` returns a live cell view, or
    ``default`` when that pair has no observations (matching the lazy
    defaultdicts the columnar state replaced)."""

    __slots__ = ("_model", "_attr")

    def __init__(self, model: "FunctionPerformanceModel", attr: str):
        self._model = model
        self._attr = attr

    def _cell(self, key) -> Optional[object]:
        m = self._model
        fi = m._frow.get(key[0])
        pi = m._pcol.get(key[1])
        if fi is None or pi is None:
            return None
        if self._attr == "exec_ewma":
            if int(m._state.exec_n[fi, pi]) == 0:
                return None
            return _EwmaCell(m, fi, pi)
        attr = "exec_q" if self._attr == "exec_p90" else "resp_q"
        if int(getattr(m._state, attr).count[fi, pi]) == 0:
            return None
        return _QuantileCell(m, attr, fi, pi)

    def get(self, key, default=None):
        cell = self._cell(key)
        return default if cell is None else cell

    def __getitem__(self, key):
        cell = self._cell(key)
        if cell is None:
            raise KeyError(key)
        return cell

    def __contains__(self, key) -> bool:
        return self._cell(key) is not None


class FunctionPerformanceModel:
    """Per (function, platform): exec-time EWMA + P90 + cold-start EWMA,
    held in preallocated columnar arrays (``PerfState``).

    ``predict`` falls back to an analytic estimate from the platform profile
    when no observations exist yet (bootstrap from FDNInspector benchmarking
    results stored in the KnowledgeBase, when available).  The scalar
    ``predict_*`` calls and the vectorized ``predict_matrix`` are IEEE-
    identical element for element — policies may use either.
    """

    ALPHA = 0.2                      # exec/cold EWMA smoothing
    Q = 0.9                          # P² quantile

    def __init__(self):
        self._state = PerfState.alloc(32, 8)
        self._frow: Dict[str, int] = {}      # function name -> row
        self._pcol: Dict[str, int] = {}      # platform name -> column
        self.version = 0                     # bumped on every state write
        # single-slot gather memo: within one admission burst the fused
        # jit step (estimator_columns) and the decision journal
        # (predict_matrix) gather the same (fns, profs) block with no
        # state write in between — keyed by object identity + version,
        # the snapshot _fn_cache discipline
        self._gather_cache = None
        self._analytic_cache = None
        self._power_cache = None
        # dict-of-estimators read surface, now backed by the arrays
        self.exec_ewma = _PairMap(self, "exec_ewma")
        self.exec_p90 = _PairMap(self, "exec_p90")
        self.resp_p90 = _PairMap(self, "resp_p90")

    # ------------------------------------------------------ state access --
    def _cell(self, fn_name: str, platform_name: str) -> Tuple[int, int]:
        """Row/column of one (function, platform) pair, growing the
        preallocated arrays by doubling when a name is new."""
        fi = self._frow.get(fn_name)
        if fi is None:
            fi = self._frow[fn_name] = len(self._frow)
        pi = self._pcol.get(platform_name)
        if pi is None:
            pi = self._pcol[platform_name] = len(self._pcol)
        nf, npl = self._state.exec_n.shape
        if fi >= nf or pi >= npl:
            while fi >= nf:
                nf *= 2
            while pi >= npl:
                npl *= 2
            self._state = self._state.grown(nf, npl)
        return fi, pi

    def _ewma_cell_add(self, v: np.ndarray, n: np.ndarray, idx,
                       x: float) -> None:
        c = int(n[idx])
        if c == 0:
            v[idx] = x
        else:
            v[idx] = self.ALPHA * x + (1 - self.ALPHA) * float(v[idx])
        n[idx] = c + 1

    # --------------------------------------------------------- updates ----
    def observe(self, inv: Invocation):
        fi, pi = self._cell(inv.fn.name, inv.platform or "?")
        st = self._state
        self._ewma_cell_add(st.exec_v, st.exec_n, (fi, pi), inv.exec_time)
        _q_add(st.exec_q, fi, pi, inv.exec_time, self.Q)
        rt = inv.response_time
        if rt is not None:
            _q_add(st.resp_q, fi, pi, rt, self.Q)
        if inv.cold_start and inv.platform:
            self._ewma_cell_add(st.cold_v, st.cold_n, pi, inv.queue_time)
        self.version += 1

    def fold_observations(self, fn_name: str, platform_name: str,
                          exec_s: float, resp_s: float, k: int) -> None:
        """Fold ``k`` identical observations into one cell in O(1) — the
        streaming-replay update, where a whole minute chunk contributes
        one aggregate per (function, platform).

        The EWMA fold is the exact closed form for a constant input
        (``v' = x + (1-a)^k (v - x)``); the P² markers advance with up to
        8 repeats of the aggregate (a constant input converges the
        estimator to itself — further identical repeats only translate
        marker positions, not heights).  This path trades bit-parity for
        O(chunks) cost and is used *only* by the streaming replayer,
        never by the discrete-event simulator."""
        if k <= 0:
            return
        fi, pi = self._cell(fn_name, platform_name)
        st = self._state
        c = int(st.exec_n[fi, pi])
        if c == 0:
            st.exec_v[fi, pi] = exec_s
        else:
            w = (1 - self.ALPHA) ** k
            st.exec_v[fi, pi] = exec_s + w * \
                (float(st.exec_v[fi, pi]) - exec_s)
        st.exec_n[fi, pi] = c + k
        reps = min(k, 8)
        for _ in range(reps):
            _q_add(st.exec_q, fi, pi, exec_s, self.Q)
            _q_add(st.resp_q, fi, pi, resp_s, self.Q)
        # account the folded population in the bootstrap gates too
        st.exec_q.count[fi, pi] += k - reps
        st.resp_q.count[fi, pi] += k - reps
        self.version += 1

    # ------------------------------------------------------ cold starts ---
    def predict_cold(self, platform_name: str,
                     default: float = float("nan")) -> float:
        pi = self._pcol.get(platform_name)
        if pi is None or int(self._state.cold_n[pi]) == 0:
            return default
        return float(self._state.cold_v[pi])

    # ------------------------------------------------- scalar predicts ----
    def analytic_exec(self, fn: FunctionSpec,
                      prof: PlatformProfile) -> float:
        compute = fn.flops / max(prof.replica_flops, 1.0)
        data = (fn.read_bytes + fn.write_bytes) / max(prof.net_bw, 1.0)
        return compute + data

    def predict_exec(self, fn: FunctionSpec, prof: PlatformProfile) -> float:
        fi = self._frow.get(fn.name)
        pi = self._pcol.get(prof.name)
        if fi is not None and pi is not None and \
                int(self._state.exec_n[fi, pi]) >= 3:
            return float(self._state.exec_v[fi, pi])
        return self.analytic_exec(fn, prof)

    def predict_p90_response(self, fn: FunctionSpec,
                             prof: PlatformProfile) -> float:
        fi = self._frow.get(fn.name)
        pi = self._pcol.get(prof.name)
        if fi is not None and pi is not None and \
                int(self._state.resp_q.count[fi, pi]) >= 10:
            return _q_value(self._state.resp_q, fi, pi, self.Q)
        return self.predict_exec(fn, prof) * 1.5

    def predict_energy(self, fn: FunctionSpec,
                       prof: PlatformProfile) -> float:
        """Joules for one invocation, charging the WHOLE platform's loaded
        power for the execution duration — the paper's Table-4 accounting
        (the platform is powered for the workload; an 11x-faster machine
        that burns 17x the power still loses on energy)."""
        t = self.predict_exec(fn, prof)
        return t * prof.nodes * prof.loaded_w_per_node

    # --------------------------------------------- vectorized predicts ----
    def _gather(self, fns: Sequence[FunctionSpec],
                profs: Sequence[PlatformProfile]):
        """Raw (F, P) gathers of the estimator grid for the given function
        x platform block: exec EWMA value/count, response-P90 height/count
        (counts zeroed for never-observed pairs)."""
        key = (self.version, tuple(id(f) for f in fns),
               tuple(id(p) for p in profs))
        hit = self._gather_cache
        if hit is not None and hit[0] == key:
            return hit[1]
        st = self._state
        rows = np.array([self._frow.get(fn.name, -1) for fn in fns],
                        dtype=np.intp)
        cols = np.array([self._pcol.get(p.name, -1) for p in profs],
                        dtype=np.intp)
        valid = (rows >= 0)[:, None] & (cols >= 0)[None, :]
        ix = np.ix_(np.maximum(rows, 0), np.maximum(cols, 0))
        ev = np.where(valid, st.exec_v[ix], 0.0)
        en = np.where(valid, st.exec_n[ix], 0)
        rh = np.where(valid, st.resp_q.heights[:, :, 2][ix], 0.0)
        rc = np.where(valid, st.resp_q.count[ix], 0)
        # cells still in the 5-sample bootstrap have no marker heights;
        # their count (< 10) keeps them on the analytic branch anyway,
        # but scrub counts so the fused step can gate on rc >= 10 alone
        rc = np.where(rc >= 5, rc, 0)
        self._gather_cache = (key, (ev, en, rh, rc))
        return ev, en, rh, rc

    def analytic_matrix(self, fns: Sequence[FunctionSpec],
                        profs: Sequence[PlatformProfile]) -> np.ndarray:
        """(F, P) analytic exec seconds — elementwise IEEE-identical to
        ``analytic_exec`` (same operand order, float64 throughout)."""
        key = (tuple(id(f) for f in fns), tuple(id(p) for p in profs))
        hit = self._analytic_cache
        if hit is not None and hit[0] == key:
            return hit[1]
        flops = np.array([fn.flops for fn in fns])
        rw = np.array([fn.read_bytes + fn.write_bytes for fn in fns])
        rfl = np.array([max(p.replica_flops, 1.0) for p in profs])
        nbw = np.array([max(p.net_bw, 1.0) for p in profs])
        out = flops[:, None] / rfl[None, :] + rw[:, None] / nbw[None, :]
        self._analytic_cache = (key, out)
        return out

    def predict_matrix(self, fns: Sequence[FunctionSpec],
                       profs: Sequence[PlatformProfile],
                       p90: bool = False, energy: bool = False
                       ) -> Dict[str, np.ndarray]:
        """One vectorized pass over the estimator arrays building the
        (F, P) prediction block the snapshot's ``fn_matrix`` serves:
        ``exec_s`` (+ ``p90_s`` / ``energy_j`` on request).  Every element
        equals the corresponding scalar ``predict_*`` call bit for bit."""
        ev, en, rh, rc = self._gather(fns, profs)
        exec_s = np.where(en >= 3, ev, self.analytic_matrix(fns, profs))
        out = {"exec_s": exec_s}
        if p90:
            out["p90_s"] = np.where(rc >= 10, rh, exec_s * 1.5)
        if energy:
            pk = tuple(id(p) for p in profs)
            hit = self._power_cache
            if hit is not None and hit[0] == pk:
                nodes, lw = hit[1]
            else:
                nodes = np.array([float(p.nodes) for p in profs])
                lw = np.array([p.loaded_w_per_node for p in profs])
                self._power_cache = (pk, (nodes, lw))
            out["energy_j"] = (exec_s * nodes[None, :]) * lw[None, :]
        return out

    def estimator_columns(self, fns: Sequence[FunctionSpec],
                          profs: Sequence[PlatformProfile]
                          ) -> Dict[str, np.ndarray]:
        """Raw gathered state for the fused jitted admission step
        (``repro_torch.kernels.policy_score.fused_composite_decide``): the
        device kernel applies the observation-count gates itself."""
        ev, en, rh, rc = self._gather(fns, profs)
        return {"ewma_v": ev, "ewma_n": en, "resp_h2": rh, "resp_n": rc,
                "analytic_s": self.analytic_matrix(fns, profs)}

    # ------------------------------------------------ deployment advice ---
    def recommend(self, fn: FunctionSpec,
                  profiles: Sequence[PlatformProfile],
                  kb=None) -> Dict[str, object]:
        """Per-function deployment advice (paper §3.6, absorbed from the
        retired Recommender): best platform for latency, for energy, and
        whether the two disagree — one ``predict_matrix`` pass instead of
        2 x P scalar predictions."""
        m = self.predict_matrix([fn], profiles, energy=True)
        lat = {p.name: float(m["exec_s"][0, j])
               for j, p in enumerate(profiles)}
        eng = {p.name: float(m["energy_j"][0, j])
               for j, p in enumerate(profiles)}
        feasible = [p for p in profiles
                    if p.total_memory_mb >= fn.memory_mb]
        if not feasible:
            return {"function": fn.name, "error": "fits nowhere"}
        best_lat = min(feasible, key=lambda p: lat[p.name]).name
        best_eng = min(feasible, key=lambda p: eng[p.name]).name
        return {
            "function": fn.name,
            "latency_best": best_lat,
            "energy_best": best_eng,
            "tradeoff": best_lat != best_eng,
            "historical": kb.best_platform(fn.name) if kb else None,
            "predicted_exec_s": {k: round(v, 4) for k, v in lat.items()},
            "predicted_energy_j": {k: round(v, 3) for k, v in eng.items()},
        }


class DataAccessModel:
    def __init__(self):
        self.reads: Dict[Tuple[str, str], int] = defaultdict(int)
        self.writes: Dict[Tuple[str, str], int] = defaultdict(int)

    def record_read(self, fn: str, obj: str, count: int = 1):
        self.reads[(fn, obj)] += count

    def record_write(self, fn: str, obj: str, count: int = 1):
        self.writes[(fn, obj)] += count

    def hot_objects(self, fn: str, k: int = 5) -> List[str]:
        items = [(o, c) for (f, o), c in self.reads.items() if f == fn]
        items.sort(key=lambda x: -x[1])
        return [o for o, _ in items[:k]]


class InteractionModel:
    """Producer->consumer edges between functions (composition, §6.3)."""

    def __init__(self, window_s: float = 1.0):
        self.window_s = window_s
        self.edges: Dict[Tuple[str, str], int] = defaultdict(int)
        self._last: Optional[Tuple[str, float]] = None

    def record(self, fn: str, t: float):
        if self._last is not None:
            lf, lt = self._last
            if t - lt <= self.window_s and lf != fn:
                self.edges[(lf, fn)] += 1
        self._last = (fn, t)

    def record_batch(self, fns: List[str], t: float):
        """Fold a simultaneous arrival burst (one batch admission) into
        the co-invocation graph — equivalent to ``record(fn, t)`` per
        invocation in stream order, but one pass: every adjacent pair of
        *distinct* functions inside the burst (dt = 0 <= window) adds one
        edge, plus the boundary pair against the previous arrival."""
        if not fns:
            return
        if self._last is not None:
            lf, lt = self._last
            if t - lt <= self.window_s and lf != fns[0]:
                self.edges[(lf, fns[0])] += 1
        for prev, cur in zip(fns, fns[1:]):
            if prev != cur:
                self.edges[(prev, cur)] += 1
        self._last = (fns[-1], t)

    def record_batch_columns(self, fn_idx: np.ndarray,
                             names: Sequence[str], t: float):
        """Columnar ``record_batch``: the burst arrives as an int column
        plus a decode table.  Edge *counts* match the sequential fold
        exactly; only the dict insertion order of brand-new edges may
        differ (np.unique visits pairs sorted, not in stream order)."""
        m = len(fn_idx)
        if m == 0:
            return
        first = names[int(fn_idx[0])]
        if self._last is not None:
            lf, lt = self._last
            if t - lt <= self.window_s and lf != first:
                self.edges[(lf, first)] += 1
        a, b = fn_idx[:-1], fn_idx[1:]
        keep = a != b
        if keep.any():
            # encode (i, j) pairs as one int64 key: a native sort inside
            # np.unique instead of the void-dtype axis=0 path, with the
            # same lexicographic visit order
            k = len(names)
            key = a[keep].astype(np.int64) * k + b[keep]
            uniq, counts = np.unique(key, return_counts=True)
            for q, c in zip(uniq.tolist(), counts.tolist()):
                self.edges[(names[q // k], names[q % k])] += int(c)
        self._last = (names[int(fn_idx[-1])], t)

    def compose_candidates(self, min_count: int = 10) -> List[Tuple[str,
                                                                    str]]:
        return [e for e, c in self.edges.items() if c >= min_count]


# ---------------------------------------------------------------------------
# Function composition (§6.3) — absorbed from the retired tuning module
# ---------------------------------------------------------------------------

def compose_functions(a: FunctionSpec, b: FunctionSpec,
                      transition_overhead_s: float = 0.0) -> FunctionSpec:
    """Compose a->b into one function (paper §6.3).

    The composed function's demands are the sums; intermediate-result I/O
    between members disappears (b's reads of a's writes become in-memory),
    and the platform charges one invocation instead of two — the paper's
    cost argument for composition.
    """
    internal = min(a.write_bytes, b.read_bytes)
    real_fn = None
    if a.real_fn is not None and b.real_fn is not None:
        def real_fn(*args, _a=a.real_fn, _b=b.real_fn):
            return _b(_a(*args))
    return FunctionSpec(
        name=f"{a.name}+{b.name}",
        flops=a.flops + b.flops,
        read_bytes=a.read_bytes + max(b.read_bytes - internal, 0.0),
        write_bytes=max(a.write_bytes - internal, 0.0) + b.write_bytes,
        memory_mb=max(a.memory_mb, b.memory_mb),
        runtime=a.runtime,
        data_objects=tuple(dict.fromkeys(a.data_objects + b.data_objects)),
        real_fn=real_fn,
        slo=SLO(min(a.slo.p90_response_s, b.slo.p90_response_s)),
    )


def composition_plan(im: InteractionModel, fns: Dict[str, FunctionSpec],
                     min_count: int = 10) -> List[FunctionSpec]:
    """Fold every hot producer->consumer edge into a composed function."""
    out = []
    for src, dst in im.compose_candidates(min_count):
        if src in fns and dst in fns:
            out.append(compose_functions(fns[src], fns[dst]))
    return out
