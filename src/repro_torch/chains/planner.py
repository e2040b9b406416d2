"""Data-gravity chain planner: place a whole chain, not one invocation.

The planner scores candidate platform assignments with a vectorized cost
model: one ``Policy.score`` call over all stages yields the (S, P)
compute/queue cost matrix from the columnar ``PlatformSnapshot``, and a
(P, P) seconds-per-byte transfer matrix (inverted
``DataPlacementManager.bandwidth_matrix``) prices every data edge, so the
whole plan is array ops — no per-stage platform scans.

The modes capture the paper's co-location vs. collaborative-execution
trade-off (§3.1.3, §5.1.4):

  ``colocate``  every stage on the single platform with the lowest
                estimated makespan *including* external-input transfer and
                a Graham-bound contention term (all the chain's work lands
                on one platform's replicas);
  ``split``     each stage greedily placed by compute/queue cost alone —
                maximal collaboration, blind to data gravity (what a
                per-invocation scheduler does today);
  ``gravity``   each stage greedily placed by compute cost + external data
                pull + inter-platform transfer from the already-placed
                predecessors (myopic data-gravity greedy);
  ``auto``      evaluate ``gravity`` and ``colocate``, keep the lower
                estimated makespan.

Estimates are planning heuristics — actual latencies come out of the
simulated execution; the FDNInspector A/B scenarios measure both.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.chains.spec import Chain
from repro_torch.core.data_placement import DataPlacementManager
from repro_torch.core.scheduler import (PlatformSnapshot, PlatformsLike,
                                        Policy, as_snapshot)
from repro_torch.core.types import FunctionSpec

PLAN_MODES = ("auto", "colocate", "split", "gravity")


@dataclass
class ChainPlan:
    """One platform assignment for a chain, with its cost estimates."""
    chain: str
    mode: str                                   # winning mode
    requested_mode: str                         # what the caller asked for
    assignment: Dict[str, str]                  # stage -> platform name
    est_makespan_s: float
    est_compute_s: float                        # summed landed stage cost
    est_transfer_s: float                       # inter-platform edge cost
    est_bytes_moved: float                      # bytes crossing platforms
    stage_cost_s: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"chain": self.chain, "mode": self.mode,
                "requested_mode": self.requested_mode,
                "assignment": dict(self.assignment),
                "est_makespan_s": self.est_makespan_s,
                "est_compute_s": self.est_compute_s,
                "est_transfer_s": self.est_transfer_s,
                "est_bytes_moved": self.est_bytes_moved}


class DataGravityPlanner:
    """Plans whole-chain placement against a platform snapshot.

    ``policy`` supplies the compute/queue cost term (stateless policies
    only: a stateful round-robin would consume rotation ticks per plan);
    ``placement`` supplies bandwidths and external-object locations;
    ``fns`` maps function names to deployed specs.
    """

    def __init__(self, policy: Policy, placement: DataPlacementManager,
                 fns: Dict[str, FunctionSpec]):
        self.policy = policy
        self.placement = placement
        self.fns = dict(fns)
        # data gravity enters through the chain's typed edges, so the
        # compute term scores data-stripped specs (no double counting of
        # fn.data_objects already expressed as external edges)
        self._stripped: Dict[str, FunctionSpec] = {}

    def stage_spec(self, function: str) -> FunctionSpec:
        s = self._stripped.get(function)
        if s is None:
            base = self.fns[function]
            s = base.replace(data_objects=()) if base.data_objects else base
            self._stripped[function] = s
        return s

    # ------------------------------------------------------ cost model ---
    def cost_matrices(self, chain: Chain, snap: PlatformSnapshot
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(C, X, T): per-stage compute/queue cost (S, P), external data-
        pull seconds (S, P), seconds-per-byte transfer matrix (P, P)."""
        C = self.policy.score_specs(
            [self.stage_spec(st.function) for st in chain.stages], snap)
        X = np.zeros_like(C)
        for si, st in enumerate(chain.stages):
            for e in chain.in_edges(st.name):
                if e.external:
                    X[si] += [self.placement.access_time(e.key, nm)
                              for nm in snap.names]
        T = 1.0 / self.placement.bandwidth_matrix(snap.names)
        return C, X, T

    def plan(self, chain: Chain, platforms: PlatformsLike,
             mode: str = "auto") -> ChainPlan:
        if mode not in PLAN_MODES:
            raise ValueError(f"unknown plan mode {mode!r}; "
                             f"choose from {PLAN_MODES}")
        snap = as_snapshot(platforms)
        C, X, T = self.cost_matrices(chain, snap)
        if mode == "colocate":
            return self._colocate(chain, snap, C, X, mode)
        if mode in ("split", "gravity"):
            return self._greedy(chain, snap, C, X, T, mode,
                                gravity=(mode == "gravity"))
        g = self._greedy(chain, snap, C, X, T, mode, gravity=True)
        c = self._colocate(chain, snap, C, X, mode)
        return g if g.est_makespan_s <= c.est_makespan_s else c

    # ---------------------------------------------------------- greedy ---
    def _greedy(self, chain: Chain, snap: PlatformSnapshot, C: np.ndarray,
                X: np.ndarray, T: np.ndarray, requested: str,
                gravity: bool) -> ChainPlan:
        """Topological greedy: each stage takes the platform minimizing its
        own landed cost given the predecessors' choices.  ``gravity=False``
        ignores every data term (compute-only collaboration)."""
        names = snap.names
        sidx = {s.name: i for i, s in enumerate(chain.stages)}
        col: Dict[str, int] = {}
        est: Dict[str, float] = {}
        stage_cost: Dict[str, float] = {}
        total_cost = transfer_s = bytes_moved = 0.0
        for sname in chain.topo_order():
            si = sidx[sname]
            cost = C[si].copy()
            if gravity:
                cost += X[si]
                for e in chain.in_edges(sname):
                    if not e.external:
                        cost += e.size_bytes * T[col[e.src]]
            j = _argmin_finite(cost)
            if j is None:
                raise ValueError(f"chain {chain.name!r}: no feasible "
                                 f"platform for stage {sname!r}")
            col[sname] = j
            # landed cost always includes the data terms (a split plan
            # still *pays* gravity, it just doesn't optimize for it)
            landed = float(C[si, j] + X[si, j])
            transfer_s += float(X[si, j])
            for e in chain.in_edges(sname):
                if e.external:
                    src = self.placement.locate(e.key, origin=names[j])
                    if src is not None and src != names[j]:
                        bytes_moved += e.size_bytes
                elif (q := col[e.src]) != j:
                    hop = e.size_bytes * float(T[q, j])
                    landed += hop
                    transfer_s += hop
                    bytes_moved += e.size_bytes
            stage_cost[sname] = landed
            total_cost += landed
            start = max((est[p] for p in chain.preds(sname)), default=0.0)
            est[sname] = start + landed
        makespan = self._with_contention(chain, snap, C, col, est)
        return ChainPlan(
            chain=chain.name, mode="gravity" if gravity else "split",
            requested_mode=requested,
            assignment={s: names[j] for s, j in col.items()},
            est_makespan_s=makespan, est_compute_s=total_cost,
            est_transfer_s=transfer_s, est_bytes_moved=bytes_moved,
            stage_cost_s=stage_cost)

    # -------------------------------------------------------- colocate ---
    def _colocate(self, chain: Chain, snap: PlatformSnapshot, C: np.ndarray,
                  X: np.ndarray, requested: str) -> ChainPlan:
        """All stages on one platform, vectorized over candidates: per-
        platform critical path + external pulls, lower-bounded by the
        Graham work/replicas contention term."""
        S, P = C.shape
        landed = C + X                        # internal edges are local
        est = np.zeros((S, P))
        sidx = {s.name: i for i, s in enumerate(chain.stages)}
        for sname in chain.topo_order():
            si = sidx[sname]
            start = np.zeros(P)
            for p in chain.preds(sname):
                start = np.maximum(start, est[sidx[p]])
            est[si] = start + landed[si]
        sink_rows = [sidx[s] for s in chain.sinks()]
        critical = est[sink_rows].max(axis=0) if sink_rows else np.zeros(P)
        fan = np.array([float(s.fan_out) for s in chain.stages])
        replicas = self._replicas(snap)
        work = (landed * fan[:, None]).sum(axis=0) / replicas
        totals = np.maximum(critical, work)
        j = _argmin_finite(totals)
        if j is None:
            raise ValueError(f"chain {chain.name!r}: no single platform "
                             "can host every stage")
        home = snap.names[j]
        bytes_moved = sum(
            e.size_bytes for e in chain.external_inputs()
            if (src := self.placement.locate(e.key, origin=home))
            is not None and src != home)
        return ChainPlan(
            chain=chain.name, mode="colocate", requested_mode=requested,
            assignment={s.name: home for s in chain.stages},
            est_makespan_s=float(totals[j]),
            est_compute_s=float(landed[:, j].sum()),
            est_transfer_s=float(X[:, j].sum()),
            est_bytes_moved=float(bytes_moved),
            stage_cost_s={s.name: float(landed[sidx[s.name], j])
                          for s in chain.stages})

    def _with_contention(self, chain: Chain, snap: PlatformSnapshot,
                         C: np.ndarray, col: Dict[str, int],
                         est: Dict[str, float]) -> float:
        """max(critical path, per-platform work / replicas)."""
        sidx = {s.name: i for i, s in enumerate(chain.stages)}
        critical = max((est[s] for s in chain.sinks()), default=0.0)
        work = np.zeros(snap.n)
        for st in chain.stages:
            work[col[st.name]] += C[sidx[st.name], col[st.name]] * \
                st.fan_out
        load = work / self._replicas(snap)
        return float(max(critical, load.max() if load.size else 0.0))

    @staticmethod
    def _replicas(snap: PlatformSnapshot) -> np.ndarray:
        return np.array([max(pr.total_replicas, 1) for pr in snap.profs],
                        dtype=float)


def _argmin_finite(row: np.ndarray) -> Optional[int]:
    """First-lowest finite column (ties like ``Policy.choose_batch``)."""
    if not np.isfinite(row).any():
        return None
    return int(np.argmin(np.where(np.isfinite(row), row, np.inf)))
