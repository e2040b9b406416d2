"""FDN Scheduler (paper §3.1.3): delivers each invocation to the right
target platform. One policy class per opportunity evaluated in §5:

  PerformanceRankedPolicy   §5.1.1  rank platforms by benchmarked performance
  UtilizationAwarePolicy    §5.1.2  avoid platforms under CPU/memory pressure
  RoundRobinCollaboration   §5.1.3  NGINX-style RR across platforms
  WeightedCollaboration     §5.1.3  weighted (e.g. 5:1) across platforms
  DataLocalityPolicy        §5.1.4  schedule near the function's data
  EnergyAwarePolicy         §5.2    cheapest energy among SLO-feasible
  SLOCompositePolicy        the full FDN decision: utilization filter ->
                            SLO feasibility -> locality cost -> energy tie-
                            break (hierarchical; node choice delegated to
                            the platform's SidecarController)

Policies are *vectorized*: the platform set is snapshotted once into
columnar NumPy arrays (``PlatformSnapshot``) and each policy produces a
``score(invs, snapshot) -> (N, P)`` cost matrix in one pass, so a whole
arrival batch is routed with array ops instead of N x P Python calls.

A batch admission decision additionally collapses to one row per
*distinct function* (policy cost depends on the FunctionSpec, not on
which invocation carries it): ``fn_decisions`` evaluates the filter
cascade + cost + argmin once per (function, platform-set) and the batch
router broadcasts the per-function choice to every invocation of that
function.  The cascade runs on one of two backends:

  * ``numpy`` — host arrays (float64; the parity oracle);
  * ``torch`` — the torch cascades of ``repro_torch.kernels.policy_score``
    on the score device (float32, as the JAX package's jitted cascades),
    with the composite policy's decision through the hand-written CUDA
    kernel K1 on its pinned staging block when
    ``policy_score.set_use_pallas(True)``.

``set_score_backend("numpy"|"torch"|"auto")`` selects it; ``auto`` (the
default, or the ``FDN_SCORE_BACKEND`` variable) uses torch for decisions
over at least ``TORCH_DECIDE_MIN`` distinct functions and numpy below that
(measured on the H100 for the kernel route; see its comment).  A decision
costs by its functions, not by the invocations that carry them.
``set_score_device`` picks
where the torch backend computes: the CUDA card unless the caller asks for
the CPU.  There is no silent degrade: the policy-score module is imported
directly, and a torch decision without a card raises.  Both backends pick
byte-identical platforms (tests pin parity on seeded scenarios), so the
choice is a throughput knob, not a semantic one.

``choose`` is the batch-of-1 case of ``choose_batch``; row-wise argmin
breaks ties exactly like the historical per-platform ``min`` scan
(first-lowest in platform order), so scalar and batch paths pick
identical platforms.
"""
from __future__ import annotations

import contextlib
import itertools
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.behavioral import FunctionPerformanceModel
from repro_torch.core.data_placement import DataPlacementManager
from repro_torch.core.platform import TargetPlatform
from repro_torch.core.types import FunctionSpec, Invocation
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import policy_score as ps

# Fewest distinct functions in a decision at which the "auto" backend
# switches to the torch cascades. chip_smoke.py times one decision of F
# functions over the five paper platforms under each backend (NVIDIA H100
# 80GB HBM3, 700 W; host ms, median of three turns); numpy / torch with K1
# on its staged block, three runs on three hosts: F=1 0.051 / 0.086,
# 0.071 / 0.119, 0.047 / 0.081; F=5 0.204 / 0.220, 0.145 / 0.156, 0.138 /
# 0.168; F=10 0.373 / 0.375, 0.278 / 0.258, 0.194 / 0.204; F=64 1.02 /
# 1.31, 1.69 / 0.95, 0.85 / 0.78; F=128 (one run) 1.87 / 1.64; F=256 4.77
# / 4.23, 3.45 / 3.06, 3.21 / 3.15 (plain torch never ahead). K1 led in
# every run only at F=256.
TORCH_DECIDE_MIN = 256

_BACKENDS = ("numpy", "torch", "auto")
_SCORE_BACKEND = os.environ.get("FDN_SCORE_BACKEND", "auto")
_SCORE_DEVICE: DeviceLike = None


def set_score_backend(mode: str) -> None:
    """Select the decision backend: "numpy", "torch", or "auto"."""
    if mode not in _BACKENDS:
        raise ValueError(f"unknown score backend {mode!r}")
    global _SCORE_BACKEND
    _SCORE_BACKEND = mode


def get_score_backend() -> str:
    return _SCORE_BACKEND


def set_score_device(device: DeviceLike) -> None:
    """Where the torch backend computes: ``None`` (the default) is the CUDA
    card, and raises ``NoCudaDevice`` at the first torch decision on a
    machine without one; ``"cpu"`` asks for the CPU."""
    global _SCORE_DEVICE
    _SCORE_DEVICE = device


def get_score_device() -> DeviceLike:
    return _SCORE_DEVICE


@contextlib.contextmanager
def score_settings(backend: str, device: DeviceLike, kernel: bool):
    """The decision backend, the score device and the switch of the
    composite decision's kernel K1 (``policy_score.set_use_pallas``) for
    the block; the earlier settings are put back after it."""
    saved = (_SCORE_BACKEND, _SCORE_DEVICE, ps.use_pallas())
    set_score_backend(backend)
    set_score_device(device)
    ps.set_use_pallas(kernel)
    try:
        yield
    finally:
        set_score_backend(saved[0])
        set_score_device(saved[1])
        ps.set_use_pallas(saved[2])


def _use_torch_backend(n_fns: int) -> bool:
    if _SCORE_BACKEND not in _BACKENDS:
        raise ValueError(f"unknown score backend {_SCORE_BACKEND!r} "
                         f"(FDN_SCORE_BACKEND); want one of {_BACKENDS}")
    if _SCORE_BACKEND == "numpy":
        return False
    return not (_SCORE_BACKEND == "auto" and n_fns < TORCH_DECIDE_MIN)


def _on_device(*arrays) -> List[torch.Tensor]:
    """Host decision inputs on the score device, float32 / int32 / bool:
    one host-to-device copy each."""
    dev = resolve(_SCORE_DEVICE)
    return [ps.as_tensor(a, dev) for a in arrays]


def _on_host(res: Tuple[torch.Tensor, torch.Tensor]
             ) -> Tuple[np.ndarray, np.ndarray]:
    """A torch decision's (choice, ok) as host arrays."""
    return res[0].cpu().numpy(), res[1].cpu().numpy()


class FnView:
    """Per-function columns over a snapshot's platforms (one row of the
    decision problem, broadcast to every invocation of that function)."""

    __slots__ = ("fn", "alive", "exec_s", "p90_s", "energy_j", "data_s",
                 "warm_free")

    def __init__(self, fn: FunctionSpec):
        self.fn = fn
        self.alive: Optional[np.ndarray] = None
        self.exec_s: Optional[np.ndarray] = None
        self.p90_s: Optional[np.ndarray] = None
        self.energy_j: Optional[np.ndarray] = None
        self.data_s: Optional[np.ndarray] = None
        self.warm_free: Optional[np.ndarray] = None


class PlatformSnapshot:
    """Columnar view of a platform set at one scheduling instant.

    Platform state (memory, CPU/memory utilization, liveness, deployment)
    is captured eagerly; per-function predictions (exec / P90 / energy /
    data-access time) are computed lazily, once per distinct function, and
    cached for the lifetime of the snapshot.  A snapshot is only valid for
    the scheduling instant it was taken at — take a fresh one per batch.
    """

    __slots__ = ("platforms", "profs", "names", "n", "failed",
                 "total_memory_mb", "cpu_util", "mem_util", "cold_start_s",
                 "_warm_total", "_power", "_fn_cache")

    def __init__(self, platforms: Sequence[TargetPlatform]):
        self.platforms = list(platforms)
        self.n = len(self.platforms)
        self.profs = [p.prof for p in self.platforms]
        self.names = [pr.name for pr in self.profs]
        self.total_memory_mb = np.array(
            [float(pr.total_memory_mb) for pr in self.profs])
        self.failed = np.array(
            [bool(getattr(p, "failed", False)) for p in self.platforms])
        self.cpu_util = np.array([self._util(p, "cpu_util")
                                  for p in self.platforms])
        self.mem_util = np.array([self._util(p, "mem_util")
                                  for p in self.platforms])
        # warm-pool columns (the autoscale layer): per-platform cold-start
        # seconds and total idle warm replicas, so policies can prefer
        # platforms with warm capacity standing by (the total is lazy —
        # no current policy consumes it on the admission hot path)
        self.cold_start_s = np.array([float(pr.cold_start_s)
                                      for pr in self.profs])
        self._warm_total: Optional[np.ndarray] = None
        self._power: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._fn_cache: Dict[tuple, FnView] = {}

    @property
    def warm_total(self) -> np.ndarray:
        if self._warm_total is None:
            self._warm_total = np.array(
                [float(p.idle_warm_total()) for p in self.platforms])
        return self._warm_total

    @property
    def power(self) -> Tuple[np.ndarray, np.ndarray]:
        """(nodes, loaded watts/node) per-platform vectors — the energy
        terms of the fused admission step."""
        if self._power is None:
            self._power = (
                np.array([float(pr.nodes) for pr in self.profs]),
                np.array([pr.loaded_w_per_node for pr in self.profs]))
        return self._power

    @staticmethod
    def _util(p, attr: str) -> float:
        f = getattr(p, attr, None)
        return float(f()) if callable(f) else 0.0

    def _base_view(self, key: tuple, fn: FunctionSpec,
                   placement: Optional[DataPlacementManager]) -> FnView:
        """The prediction-free columns of one function's view (liveness,
        data-access seconds, warm-pool) — created once per cache key."""
        v = self._fn_cache.get(key)
        if v is None:
            v = FnView(fn)
            deployed = np.array([fn.name in getattr(p, "deployed", {})
                                 for p in self.platforms])
            v.alive = (~self.failed) & deployed & \
                (self.total_memory_mb >= fn.memory_mb)
            if placement is not None and fn.data_objects:
                v.data_s = np.array(
                    [sum(placement.access_time(o, name)
                         for o in fn.data_objects) for name in self.names])
            else:
                v.data_s = np.zeros(self.n)
            v.warm_free = np.array(
                [float(p.idle_warm(fn.name)) for p in self.platforms])
            self._fn_cache[key] = v
        return v

    def fn_view(self, fn: FunctionSpec,
                perf: Optional[FunctionPerformanceModel] = None,
                placement: Optional[DataPlacementManager] = None,
                p90: bool = False, energy: bool = False) -> FnView:
        """Columns are computed on demand (a perf-ranked policy must not
        pay for P90/energy predictions) and filled incrementally on cache
        hits when a later policy asks for more."""
        # keyed by object identity: FunctionSpec hashing walks every field,
        # which is far too slow for 10^5-row batches
        v = self._base_view((id(fn), id(perf), id(placement)), fn,
                            placement)
        if perf is not None:
            if v.exec_s is None:
                v.exec_s = np.array([perf.predict_exec(fn, pr)
                                     for pr in self.profs])
            if p90 and v.p90_s is None:
                v.p90_s = np.array([perf.predict_p90_response(fn, pr)
                                    for pr in self.profs])
            if energy and v.energy_j is None:
                v.energy_j = np.array([perf.predict_energy(fn, pr)
                                       for pr in self.profs])
        return v

    def fn_matrix(self, fns: Sequence[FunctionSpec],
                  perf: Optional[FunctionPerformanceModel] = None,
                  placement: Optional[DataPlacementManager] = None,
                  p90: bool = False, energy: bool = False
                  ) -> Dict[str, np.ndarray]:
        """(F, P) matrices stacked from the per-function views — the
        columnar input the jitted decision cascades consume.

        Prediction columns for functions not yet in the snapshot cache
        are built by ONE vectorized ``perf.predict_matrix`` pass over the
        columnar estimator state (bit-identical to the scalar
        ``predict_*`` loop the single-function path keeps)."""
        if perf is None or len(fns) == 1:
            views = [self.fn_view(fn, perf, placement, p90=p90,
                                  energy=energy) for fn in fns]
        else:
            views = [self._base_view((id(fn), id(perf), id(placement)),
                                     fn, placement) for fn in fns]
            seen = set()
            fill_fns, fill_views = [], []
            for fn, v in zip(fns, views):
                if id(fn) in seen:
                    continue
                seen.add(id(fn))
                if v.exec_s is None or (p90 and v.p90_s is None) or \
                        (energy and v.energy_j is None):
                    fill_fns.append(fn)
                    fill_views.append(v)
            if fill_fns:
                m = perf.predict_matrix(fill_fns, self.profs, p90=p90,
                                        energy=energy)
                for r, v in enumerate(fill_views):
                    if v.exec_s is None:
                        v.exec_s = m["exec_s"][r]
                    if p90 and v.p90_s is None:
                        v.p90_s = m["p90_s"][r]
                    if energy and v.energy_j is None:
                        v.energy_j = m["energy_j"][r]
        if len(views) == 1:                  # scalar choose: views, no copy
            v = views[0]
            out = {"alive": v.alive[None], "data_s": v.data_s[None],
                   "warm_free": v.warm_free[None]}
            if perf is not None:
                out["exec_s"] = v.exec_s[None]
                if p90:
                    out["p90_s"] = v.p90_s[None]
                if energy:
                    out["energy_j"] = v.energy_j[None]
            return out
        out = {"alive": np.stack([v.alive for v in views]),
               "data_s": np.stack([v.data_s for v in views]),
               "warm_free": np.stack([v.warm_free for v in views])}
        if perf is not None:
            out["exec_s"] = np.stack([v.exec_s for v in views])
            if p90:
                out["p90_s"] = np.stack([v.p90_s for v in views])
            if energy:
                out["energy_j"] = np.stack([v.energy_j for v in views])
        return out


PlatformsLike = Union[PlatformSnapshot, Sequence[TargetPlatform]]


def as_snapshot(platforms: PlatformsLike) -> PlatformSnapshot:
    if isinstance(platforms, PlatformSnapshot):
        return platforms
    return PlatformSnapshot(platforms)


def group_by_fn(invs: Sequence[Invocation]
                ) -> List[Tuple[FunctionSpec, List[int]]]:
    """Distinct functions (by object identity, first-appearance order)
    with the invocation indices that carry each."""
    groups: Dict[int, Tuple[FunctionSpec, List[int]]] = {}
    order: List[Tuple[FunctionSpec, List[int]]] = []
    for i, inv in enumerate(invs):
        g = groups.get(id(inv.fn))
        if g is None:
            g = (inv.fn, [i])
            groups[id(inv.fn)] = g
            order.append(g)
        else:
            g[1].append(i)
    return order


class _SpecInv:
    """Invocation-shaped wrapper: lets bare FunctionSpecs flow through
    ``Policy.score`` (policies only read ``inv.fn``).  Chain planning
    scores *stages* — functions that have no live invocation yet."""

    __slots__ = ("fn",)

    def __init__(self, fn: FunctionSpec):
        self.fn = fn


# Filter-kill bitmask bits recorded by the decision journal
# (the JAX package's obs.provenance).  Values mirror
# ``repro_torch.kernels.policy_score``.
KILL_DEAD = 1    # platform failed / no replicas (alive mask)
KILL_UTIL = 2    # alive but dropped by the utilization filter
KILL_SLO = 4     # survived utilization but dropped by SLO feasibility


def _row(x: np.ndarray) -> np.ndarray:
    """Broadcast a per-platform (P,) vector against (F, P) matrices; a
    journal replay passes already-row-shaped (rows, P) matrices through
    unchanged — broadcasting duplicates values, so the elementwise
    arithmetic is bit-identical either way."""
    return x if x.ndim == 2 else x[None, :]


def decision_features(fns: Sequence[FunctionSpec], snap: PlatformSnapshot,
                      perf: FunctionPerformanceModel,
                      placement: Optional[DataPlacementManager]
                      ) -> Dict[str, np.ndarray]:
    """The full standard feature set every stateless policy cascade is a
    pure function of — one (F, P) matrix or (P,)/(F,) vector per signal.
    The decision journal snapshots exactly these columns so an offline
    what-if replay can re-score them under *any* policy/params.

    Base columns and predictions are fetched separately — the same
    two-step shape as the fused jit path, so on the admission hot path
    both the snapshot's base-view cache and the perf model's gather
    memo hit and this costs stacks + three ``np.where`` passes."""
    base = snap.fn_matrix(fns, None, placement)
    pred = perf.predict_matrix(fns, snap.profs, p90=True, energy=True)
    return {
        "alive": base["alive"], "exec_s": pred["exec_s"],
        "data_s": base["data_s"], "p90_s": pred["p90_s"],
        "energy_j": pred["energy_j"], "warm_free": base["warm_free"],
        "cpu_util": snap.cpu_util, "mem_util": snap.mem_util,
        "cold_start_s": snap.cold_start_s,
        "slo_s": _slo_vector(fns),
    }


class Policy:
    name = "base"

    # Stateless policies expose ``cascade``: a pure staticmethod over the
    # ``decision_features`` columns returning (cost (F, P) float64,
    # kill (F, P) uint8 bitmask; kill == 0 marks feasible-after-degrade).
    # It mirrors ``fn_cost_matrix`` op for op, so re-running it over
    # journaled feature columns reproduces the original numpy-backend
    # choices byte-identically (the what-if correctness oracle).
    # Stateful rotation policies keep ``cascade = None``.
    cascade = None
    # Tunables ``cascade`` reads from its params dict, with defaults
    # matching the policy constructor; ``cascade_params`` extracts the
    # live instance's values.
    CASCADE_PARAMS: Dict[str, float] = {}

    def cascade_params(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in type(self).CASCADE_PARAMS}

    # ------------------------------------------------- vectorized core ---
    def fn_cost_matrix(self, fns: Sequence[FunctionSpec],
                       snap: PlatformSnapshot) -> Optional[np.ndarray]:
        """(F, P) masked cost matrix, one row per distinct function
        (np.inf marks an infeasible pairing) — or None for policies whose
        score is per-invocation stateful (rotation policies)."""
        return None

    # decisions this policy made on the torch backend
    torch_decisions = 0

    def _torch_decide(self, fns: Sequence[FunctionSpec],
                      snap: PlatformSnapshot
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Torch-cascade decision (repro_torch.kernels.policy_score) on the
        score device, (choice, ok) brought to the host; None when this
        policy has no such variant."""
        return None

    def fn_decisions(self, fns: Sequence[FunctionSpec],
                     snap: PlatformSnapshot
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Fused decision per distinct function: (platform index, any-
        feasible) arrays of shape (F,), on the backend that "auto" picks
        for F functions.  Returns None for stateful policies — callers
        fall back to the full score matrix.
        """
        if _use_torch_backend(len(fns)):
            res = self._torch_decide(fns, snap)
            if res is not None:
                self.torch_decisions += 1
                return res
        rows = self.fn_cost_matrix(fns, snap)
        if rows is None:
            return None
        finite = np.isfinite(rows)
        return (np.argmin(np.where(finite, rows, np.inf), axis=1),
                finite.any(axis=1))

    def score(self, invs: Sequence[Invocation],
              snap: PlatformSnapshot) -> np.ndarray:
        """(N, P) cost matrix; np.inf marks an infeasible pairing."""
        groups = group_by_fn(invs)
        rows = self.fn_cost_matrix([g[0] for g in groups], snap)
        if rows is None:
            raise NotImplementedError
        out = np.empty((len(invs), snap.n))
        for g, (_fn, idxs) in enumerate(groups):
            out[idxs] = rows[g]
        return out

    def score_specs(self, specs: Sequence[FunctionSpec],
                    platforms: PlatformsLike) -> np.ndarray:
        """(N, P) cost matrix for bare FunctionSpecs (one row per spec) —
        the whole-chain planner's entry point."""
        return self.score([_SpecInv(f) for f in specs],
                          as_snapshot(platforms))

    def choose_batch(self, invs: Sequence[Invocation],
                     platforms: PlatformsLike
                     ) -> List[Optional[TargetPlatform]]:
        """Route a whole batch in one policy evaluation.

        Stateless policies collapse to one fused decision per distinct
        function (``fn_decisions``); stateful ones keep the historical
        full-matrix row-wise argmin.  Both break ties first-lowest."""
        snap = as_snapshot(platforms)
        if not invs or snap.n == 0:
            return [None] * len(invs)
        groups = group_by_fn(invs)
        res = self.fn_decisions([g[0] for g in groups], snap)
        plats = snap.platforms
        if res is None:
            costs = self.score(invs, snap)
            finite = np.isfinite(costs)
            any_ok = finite.any(axis=1)
            idx = np.argmin(np.where(finite, costs, np.inf), axis=1)
            return [plats[j] if ok else None
                    for j, ok in zip(idx.tolist(), any_ok.tolist())]
        idx, ok_arr = res
        out: List[Optional[TargetPlatform]] = [None] * len(invs)
        for g, (_fn, idxs) in enumerate(groups):
            if ok_arr[g]:
                p = plats[int(idx[g])]
                for i in idxs:
                    out[i] = p
        return out

    def choose(self, inv: Invocation,
               platforms: PlatformsLike) -> Optional[TargetPlatform]:
        return self.choose_batch([inv], platforms)[0]


def _masked(cost: np.ndarray, mask: np.ndarray) -> np.ndarray:
    return np.where(mask, cost, np.inf)


class PerformanceRankedPolicy(Policy):
    name = "perf_ranked"

    def __init__(self, perf: FunctionPerformanceModel):
        self.perf = perf

    def fn_cost_matrix(self, fns, snap):
        m = snap.fn_matrix(fns, self.perf)
        return _masked(m["exec_s"], m["alive"])

    def _torch_decide(self, fns, snap):
        m = snap.fn_matrix(fns, self.perf)
        return _on_host(ps.perf_ranked_decide(
            *_on_device(m["exec_s"], m["alive"])))

    @staticmethod
    def cascade(feats, params):
        alive = feats["alive"]
        kill = np.where(~alive, KILL_DEAD, 0).astype(np.uint8)
        return feats["exec_s"], kill


class UtilizationAwarePolicy(Policy):
    name = "utilization_aware"

    def __init__(self, perf: FunctionPerformanceModel,
                 cpu_threshold: float = 0.9, mem_threshold: float = 0.9):
        self.perf = perf
        self.cpu_threshold = cpu_threshold
        self.mem_threshold = mem_threshold

    def _unloaded(self, snap):
        return (snap.cpu_util < self.cpu_threshold) & \
            (snap.mem_util < self.mem_threshold)

    def fn_cost_matrix(self, fns, snap):
        m = snap.fn_matrix(fns, self.perf)
        ok = m["alive"] & self._unloaded(snap)[None, :]
        ok = np.where(ok.any(axis=1, keepdims=True), ok, m["alive"])
        return _masked(m["exec_s"], ok)

    def _torch_decide(self, fns, snap):
        m = snap.fn_matrix(fns, self.perf)
        return _on_host(ps.utilization_decide(
            *_on_device(m["exec_s"], m["alive"], self._unloaded(snap))))

    CASCADE_PARAMS = {"cpu_threshold": 0.9, "mem_threshold": 0.9}

    @staticmethod
    def cascade(feats, params):
        alive = feats["alive"]
        unloaded = _row((feats["cpu_util"] < params["cpu_threshold"]) &
                        (feats["mem_util"] < params["mem_threshold"]))
        ok = alive & unloaded
        ok = np.where(ok.any(axis=1, keepdims=True), ok, alive)
        kill = (np.where(~alive, KILL_DEAD, 0) |
                np.where(alive & ~ok, KILL_UTIL, 0)).astype(np.uint8)
        return feats["exec_s"], kill


class RoundRobinCollaboration(Policy):
    """Stateful: ``score`` consumes one rotation tick per row, so batch
    routing advances the round-robin exactly like N scalar ``choose``s."""
    name = "round_robin"

    def __init__(self):
        self._rr = itertools.count()

    def score(self, invs, snap):
        out = np.full((len(invs), snap.n), np.inf)
        cand_cache: Dict[int, List[int]] = {}
        for i, inv in enumerate(invs):
            cand = cand_cache.get(id(inv.fn))
            if cand is None:
                alive = snap.fn_view(inv.fn).alive
                cand = np.flatnonzero(alive).tolist()
                cand_cache[id(inv.fn)] = cand
            if cand:
                out[i, cand[next(self._rr) % len(cand)]] = 0.0
        return out


class WeightedCollaboration(Policy):
    """Static weights (paper used old-hpc:cloud = 5:1); weights may also be
    derived from the performance model (capacity-proportional). Stateful:
    ``score`` walks the weighted schedule one row at a time."""
    name = "weighted"

    def __init__(self, weights: Dict[str, int]):
        self.weights = dict(weights)
        self._sched: List[str] = []
        for name, w in weights.items():
            self._sched += [name] * max(int(w), 0)
        self._i = 0

    @classmethod
    def from_perf(cls, fn: FunctionSpec, perf: FunctionPerformanceModel,
                  platforms: Sequence[TargetPlatform], scale: int = 10):
        """Capacity-proportional weights: w ~ replicas / exec_time."""
        ws = {}
        for p in platforms:
            t = max(perf.predict_exec(fn, p.prof), 1e-6)
            ws[p.prof.name] = max(1, round(
                scale * p.prof.total_replicas / t /
                max(sum(q.prof.total_replicas for q in platforms), 1)))
        return cls(ws)

    def _pick(self, cand_cols: Dict[str, int]) -> Optional[int]:
        if not cand_cols or not self._sched:
            return next(iter(cand_cols.values()), None)
        for _ in range(len(self._sched)):
            name = self._sched[self._i % len(self._sched)]
            self._i += 1
            if name in cand_cols:
                return cand_cols[name]
        return next(iter(cand_cols.values()), None)

    def score(self, invs, snap):
        out = np.full((len(invs), snap.n), np.inf)
        cand_cache: Dict[int, Dict[str, int]] = {}
        for i, inv in enumerate(invs):
            cand = cand_cache.get(id(inv.fn))
            if cand is None:
                alive = snap.fn_view(inv.fn).alive
                cand = {snap.names[j]: j for j in np.flatnonzero(alive)}
                cand_cache[id(inv.fn)] = cand
            col = self._pick(cand)
            if col is not None:
                out[i, col] = 0.0
        return out


class DataLocalityPolicy(Policy):
    name = "data_locality"

    def __init__(self, perf: FunctionPerformanceModel,
                 placement: DataPlacementManager):
        self.perf = perf
        self.placement = placement

    def fn_cost_matrix(self, fns, snap):
        m = snap.fn_matrix(fns, self.perf, self.placement)
        return _masked(m["exec_s"] + m["data_s"], m["alive"])

    def _torch_decide(self, fns, snap):
        m = snap.fn_matrix(fns, self.perf, self.placement)
        return _on_host(ps.locality_decide(
            *_on_device(m["exec_s"], m["data_s"], m["alive"])))

    @staticmethod
    def cascade(feats, params):
        alive = feats["alive"]
        kill = np.where(~alive, KILL_DEAD, 0).astype(np.uint8)
        return feats["exec_s"] + feats["data_s"], kill


class WarmAwarePolicy(Policy):
    """Cold-start-aware routing over the snapshot's warm-pool columns
    (the autoscale layer): locality-adjusted latency plus the platform's full
    cold-start penalty whenever the function has no idle warm replica
    standing by — so traffic prefers platforms whose warm pools (TTL'd or
    predictively prewarmed) already hold capacity for it."""

    name = "warm_aware"

    def __init__(self, perf: FunctionPerformanceModel,
                 placement: Optional[DataPlacementManager] = None):
        self.perf = perf
        self.placement = placement

    def fn_cost_matrix(self, fns, snap):
        m = snap.fn_matrix(fns, self.perf, self.placement)
        cold = np.where(m["warm_free"] > 0.0, 0.0,
                        snap.cold_start_s[None, :])
        return _masked(m["exec_s"] + m["data_s"] + cold, m["alive"])

    def _torch_decide(self, fns, snap):
        m = snap.fn_matrix(fns, self.perf, self.placement)
        return _on_host(ps.warm_decide(
            *_on_device(m["exec_s"], m["data_s"], m["warm_free"],
                        snap.cold_start_s, m["alive"])))

    @staticmethod
    def cascade(feats, params):
        alive = feats["alive"]
        cold = np.where(feats["warm_free"] > 0.0, 0.0,
                        _row(feats["cold_start_s"]))
        kill = np.where(~alive, KILL_DEAD, 0).astype(np.uint8)
        return feats["exec_s"] + feats["data_s"] + cold, kill


def _slo_vector(fns: Sequence[FunctionSpec]) -> np.ndarray:
    return np.array([fn.slo.p90_response_s for fn in fns])


class EnergyAwarePolicy(Policy):
    """§5.2: among platforms predicted to meet the SLO, pick the one with
    the lowest predicted energy per invocation (the 17x edge result)."""
    name = "energy_aware"

    def __init__(self, perf: FunctionPerformanceModel):
        self.perf = perf

    def fn_cost_matrix(self, fns, snap):
        m = snap.fn_matrix(fns, self.perf, p90=True, energy=True)
        feasible = m["alive"] & (m["p90_s"] <= _slo_vector(fns)[:, None])
        feasible = np.where(feasible.any(axis=1, keepdims=True), feasible,
                            m["alive"])
        return _masked(m["energy_j"], feasible)

    def _torch_decide(self, fns, snap):
        m = snap.fn_matrix(fns, self.perf, p90=True, energy=True)
        return _on_host(ps.energy_decide(
            *_on_device(m["energy_j"], m["p90_s"], _slo_vector(fns),
                        m["alive"])))

    @staticmethod
    def cascade(feats, params):
        alive = feats["alive"]
        feasible = alive & (feats["p90_s"] <= feats["slo_s"][:, None])
        feasible = np.where(feasible.any(axis=1, keepdims=True), feasible,
                            alive)
        kill = (np.where(~alive, KILL_DEAD, 0) |
                np.where(alive & ~feasible, KILL_SLO, 0)).astype(np.uint8)
        return feats["energy_j"], kill


class SLOCompositePolicy(Policy):
    """The FDN's production policy: hierarchical composite decision,
    reduced to a filter cascade over the snapshot's columns:
    utilization mask -> SLO-feasibility mask -> locality-adjusted latency
    + energy tie-break."""

    name = "slo_composite"

    def __init__(self, perf: FunctionPerformanceModel,
                 placement: Optional[DataPlacementManager] = None,
                 cpu_threshold: float = 0.9, mem_threshold: float = 0.95,
                 energy_weight: float = 0.1):
        self.perf = perf
        self.placement = placement
        self.cpu_threshold = cpu_threshold
        self.mem_threshold = mem_threshold
        self.energy_weight = energy_weight

    def _unloaded(self, snap):
        return (snap.cpu_util < self.cpu_threshold) & \
            (snap.mem_util < self.mem_threshold)

    def _columns(self, fns, snap):
        return snap.fn_matrix(fns, self.perf, self.placement,
                              p90=True, energy=True)

    def fn_cost_matrix(self, fns, snap):
        m = self._columns(fns, snap)
        # (1) utilization filter (§5.1.2)
        ok = m["alive"] & self._unloaded(snap)[None, :]
        ok = np.where(ok.any(axis=1, keepdims=True), ok, m["alive"])
        # (2) SLO feasibility (§5.1.1)
        feasible = ok & (m["p90_s"] <= _slo_vector(fns)[:, None])
        feasible = np.where(feasible.any(axis=1, keepdims=True), feasible,
                            ok)
        # (3) locality-adjusted latency + energy tie-break (§5.1.4, §5.2)
        cost = (m["exec_s"] + m["data_s"]) + \
            self.energy_weight * m["energy_j"]
        return _masked(cost, feasible)

    def _fused_inputs(self, fns, snap):
        """The fused step's eleven host arrays: raw estimator state, data
        seconds, power terms, masks and SLOs."""
        base = snap.fn_matrix(fns, None, self.placement)
        est = self.perf.estimator_columns(fns, snap.profs)
        nodes, loaded_w = snap.power
        return (est["ewma_v"], est["ewma_n"], est["analytic_s"],
                est["resp_h2"], est["resp_n"], base["data_s"], nodes,
                loaded_w, base["alive"], self._unloaded(snap),
                _slo_vector(fns))

    def _torch_decide(self, fns, snap):
        """ONE fused step from raw estimator state: snapshot prediction
        columns (EWMA/P² gates, power model), filter cascade and argmin
        on the score device — the host never materializes exec/P90/energy
        matrices on this path. With ``set_use_pallas(True)`` on the card
        the whole step is one launch of the CUDA kernel K1 on its staging
        block (``fused_composite_decide_staged``): the eleven host arrays
        are written into one pinned block that the card reads in place, and
        one sync returns the result."""
        host = self._fused_inputs(fns, snap)
        dev = resolve(_SCORE_DEVICE)
        if ps.use_pallas() and dev.type == "cuda":
            return ps.fused_composite_decide_staged(
                *host, self.energy_weight, device=dev)
        return _on_host(ps.fused_composite_decide(*_on_device(*host),
                                                  self.energy_weight))

    CASCADE_PARAMS = {"cpu_threshold": 0.9, "mem_threshold": 0.95,
                      "energy_weight": 0.1}

    @staticmethod
    def cascade(feats, params):
        alive = feats["alive"]
        unloaded = _row((feats["cpu_util"] < params["cpu_threshold"]) &
                        (feats["mem_util"] < params["mem_threshold"]))
        ok = alive & unloaded
        ok = np.where(ok.any(axis=1, keepdims=True), ok, alive)
        feasible = ok & (feats["p90_s"] <= feats["slo_s"][:, None])
        feasible = np.where(feasible.any(axis=1, keepdims=True), feasible,
                            ok)
        cost = (feats["exec_s"] + feats["data_s"]) + \
            params["energy_weight"] * feats["energy_j"]
        kill = (np.where(~alive, KILL_DEAD, 0) |
                np.where(alive & ~ok, KILL_UTIL, 0) |
                np.where(ok & ~feasible, KILL_SLO, 0)).astype(np.uint8)
        return cost, kill


POLICIES = {cls.name: cls for cls in
            (PerformanceRankedPolicy, UtilizationAwarePolicy,
             RoundRobinCollaboration, WeightedCollaboration,
             DataLocalityPolicy, WarmAwarePolicy, EnergyAwarePolicy,
             SLOCompositePolicy)}
