"""Counterfactual what-if replay over journaled decision columns.

``replay`` re-scores a ``DecisionJournal``'s snapshot feature columns
offline — no simulation re-run — under any stateless registry policy
and/or alternate cascade params / scaled SLOs.  The policy ``cascade``
staticmethods are pure functions of exactly the journaled features and
mirror the live ``fn_cost_matrix`` arithmetic op for op, so replaying
under the *same* policy and params reproduces the original (numpy-
backend) choices byte-identically — ``replay_matches`` is the
correctness oracle pinned by tests and the ``run.py explain`` flow.

Journal rows are grouped by platform-set id; each group replays as one
dense (rows, P) cascade + masked argmin, first-lowest tie-break —
identical to the live ``fn_decisions`` host path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.core.scheduler import POLICIES
from repro_torch.obs.provenance import FEATURE_COLS, DecisionJournal


@dataclass
class WhatIfConfig:
    """An alternate universe to re-score the journal under."""
    policy: str
    params: Dict[str, float] = field(default_factory=dict)
    slo_scale: float = 1.0

    @classmethod
    def parse(cls, text: str) -> "WhatIfConfig":
        """``policy=NAME[,key=value...]`` (``slo_scale`` is recognized as
        a config key; everything else is a cascade param override)."""
        policy, params, slo_scale = None, {}, 1.0
        for part in text.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k == "policy":
                policy = v.strip()
            elif k == "slo_scale":
                slo_scale = float(v)
            else:
                params[k] = float(v)
        if policy is None:
            raise ValueError(f"--whatif needs policy=NAME, got {text!r}")
        return cls(policy, params, slo_scale)


@dataclass
class ReplayResult:
    policy: str
    params: Dict[str, float]
    slo_scale: float
    choice: np.ndarray          # (n,) int16 chosen slot, -1 infeasible
    ok: np.ndarray              # (n,) bool
    est_s: np.ndarray           # (n,) chosen exec+data estimate (NaN if -1)

    def matches(self, journal: DecisionJournal) -> bool:
        """The byte-identical same-policy oracle."""
        return bool(np.array_equal(self.choice,
                                   journal.columns()["choice"]))


def _resolve(journal: DecisionJournal, cfg: Optional[WhatIfConfig]):
    if cfg is None:
        name = journal.policy_name
        params = dict(journal.params)
        slo_scale = 1.0
    else:
        name = cfg.policy
        cls = POLICIES.get(name)
        if cls is None:
            raise ValueError(f"unknown policy {name!r}")
        params = {**cls.CASCADE_PARAMS, **cfg.params}
        slo_scale = cfg.slo_scale
    cascade = getattr(POLICIES[name], "cascade", None)
    if cascade is None:
        raise ValueError(
            f"policy {name!r} is stateful (no cascade) — not replayable")
    return name, params, slo_scale, cascade


def replay(journal: DecisionJournal,
           cfg: Optional[WhatIfConfig] = None) -> ReplayResult:
    """Re-score every journal row.  ``cfg=None`` replays under the
    journaled policy + params (the oracle configuration)."""
    name, params, slo_scale, cascade = _resolve(journal, cfg)
    n = journal.n
    jc = journal.columns()
    choice = np.full(n, -1, np.int16)
    ok = np.zeros(n, bool)
    est_out = np.full(n, np.nan)
    for pid in np.unique(jc["pset"]) if n else ():
        mask = jc["pset"] == pid
        P = len(journal.pset_names[int(pid)])
        feats = {name2: jc[name2][mask][:, :P] for name2 in FEATURE_COLS}
        feats["alive"] = jc["alive"][mask][:, :P]
        feats["slo_s"] = jc["slo_s"][mask] * slo_scale
        cost, kill = cascade(feats, params)
        masked = np.where((kill == 0) & np.isfinite(cost), cost, np.inf)
        finite = np.isfinite(masked)
        any_ok = finite.any(axis=1)
        ch = np.argmin(masked, axis=1).astype(np.int16)
        ch = np.where(any_ok, ch, -1).astype(np.int16)
        est = feats["exec_s"] + feats["data_s"]
        chosen_est = est[np.arange(ch.size), np.maximum(ch, 0)]
        choice[mask] = ch
        ok[mask] = any_ok
        est_out[mask] = np.where(ch >= 0, chosen_est, np.nan)
    return ReplayResult(name, params, slo_scale, choice, ok, est_out)


def replay_matches(journal: DecisionJournal) -> bool:
    """Same-policy replay oracle: True iff re-scoring the journal under
    its own policy reproduces every journaled choice byte-identically."""
    return replay(journal).matches(journal)


def whatif_section(journal: DecisionJournal, base: ReplayResult,
                   alt: ReplayResult) -> Dict:
    """Counterfactual summary: how the alternate config's choices differ
    from the journaled ones, invocation-weighted."""
    jc = journal.columns()
    counts = jc["count"].astype(np.int64)
    n = journal.n
    changed = alt.choice != jc["choice"]
    base_est = base.est_s
    both = ~np.isnan(base_est) & ~np.isnan(alt.est_s)
    delta = alt.est_s[both] - base_est[both]
    w = counts[both]

    def shift(res_choice: np.ndarray) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for pid in np.unique(jc["pset"]) if n else ():
            names = journal.pset_names[int(pid)]
            mask = jc["pset"] == pid
            for slot in range(len(names)):
                c = int(counts[mask & (res_choice == slot)].sum())
                if c:
                    out[names[slot]] = out.get(names[slot], 0) + c
        return out

    return {
        "policy": alt.policy,
        "params": {k: float(v) for k, v in sorted(alt.params.items())},
        "slo_scale": float(alt.slo_scale),
        "decisions": int(n),
        "changed_decisions": int(changed.sum()),
        "changed_invocations": int(counts[changed].sum()),
        "changed_rate": float(changed.mean()) if n else 0.0,
        "platform_share_before": shift(jc["choice"]),
        "platform_share_after": shift(alt.choice),
        "est_latency_delta_mean_s":
            float((delta * w).sum() / w.sum()) if w.sum() else 0.0,
        "infeasible_after": int((alt.choice < 0).sum()),
    }
