"""Seeded decision inputs for holding the policy-score kernels (K1, K2)
against their plain versions and the JAX package's cascades: the CPU
tests, the card tests and ``chip_smoke.py`` draw their cases here.

``make_case`` returns one decision's raw estimator state and platform
columns as NumPy arrays, float64 and int64 as the host hands them over;
``prebuilt_columns`` the float32 exec / P90 / energy columns that K1 builds
from them (K2's inputs). Each kind stresses one part of the cascade:

  random        estimator gates on both branches, some dead cells, some
                loaded platforms, SLOs that some cells miss;
  util_degrade  no unloaded platform (or one), so the utilization filter
                empties rows and degrades to ``alive``;
  slo_degrade   SLOs nothing can meet in about half the rows;
  all_dead      no alive platform in about half the rows;
  tie           columns 1 and 3 carry one cost in every row;
  near_tie      columns 1 and 3 one float32 ulp apart, the lower one in
                column 3 on odd rows;
  nonfinite     NaN, +inf and -inf execution estimates in feasible cells,
                and whole rows of NaN.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

KINDS = ("random", "util_degrade", "slo_degrade", "all_dead", "tie",
         "near_tie", "nonfinite")
# K1's arguments before the energy weight, in order
FUSED_ARGS = ("ewma_v", "ewma_n", "analytic_s", "resp_h2", "resp_n",
              "data_s", "nodes", "loaded_w", "alive", "unloaded", "slo_s")
# K2's (``composite_decide``'s) arguments before the energy weight
PREBUILT_ARGS = ("exec_s", "data_s", "p90_s", "energy_j", "alive",
                 "unloaded", "slo_s")


def make_case(seed: int, f: int, p: int, kind: str,
              weight: float = 0.1) -> Dict[str, object]:
    """One (F=f, P=p) decision of ``kind``; ``energy_weight`` is
    ``weight`` except for the tie kinds, which need 0."""
    rng = np.random.default_rng(seed)
    c = {
        "ewma_v": rng.uniform(0.01, 8.0, (f, p)),
        "ewma_n": rng.integers(0, 6, (f, p)),
        "analytic_s": rng.uniform(0.01, 8.0, (f, p)),
        "resp_h2": rng.uniform(0.01, 12.0, (f, p)),
        "resp_n": rng.integers(0, 20, (f, p)),
        "data_s": np.where(rng.random((f, p)) < 0.5, 0.0,
                           rng.uniform(0, 2.0, (f, p))),
        "nodes": rng.integers(1, 4, p).astype(float),
        "loaded_w": rng.uniform(1.0, 150.0, p),
        "alive": rng.random((f, p)) < 0.8,
        "unloaded": rng.random(p) < 0.7,
        "slo_s": rng.uniform(0.5, 12.0, f),
        "energy_weight": weight,
    }
    rows = rng.random(f) < 0.5
    if kind == "util_degrade":
        c["unloaded"][:] = False
        c["unloaded"][0] = rng.random() < 0.5
    elif kind == "slo_degrade":
        c["slo_s"][rows] = 1e-4
    elif kind == "all_dead":
        c["alive"][rows] = False
    elif kind in ("tie", "near_tie"):
        c["ewma_n"][:] = 5
        c["data_s"][:] = 0.0
        c["energy_weight"] = 0.0
        c["alive"][:] = True
        c["unloaded"][:] = True
        c["slo_s"][:] = 1e9
        base = rng.uniform(0.01, 0.02, f).astype(np.float32)
        other = base if kind == "tie" else np.nextafter(
            base, np.float32(np.inf))
        c["ewma_v"][:] = 1.0
        c["ewma_v"][:, 1 % p] = base
        c["ewma_v"][:, 3 % p] = other
        if kind == "near_tie":
            odd = np.arange(f) % 2 == 1
            c["ewma_v"][odd, 1 % p] = other[odd]
            c["ewma_v"][odd, 3 % p] = base[odd]
    elif kind == "nonfinite":
        c["ewma_n"][:] = 5
        vals = np.array([np.nan, np.inf, -np.inf])
        hit = rng.random((f, p)) < 0.3
        c["ewma_v"][hit] = vals[rng.integers(0, 3, int(hit.sum()))]
        c["ewma_v"][rows & (np.arange(f) % 3 == 0), :] = np.nan
    elif kind != "random":
        raise ValueError(f"unknown case kind {kind!r}")
    return c


def prebuilt_columns(c: Dict[str, object]) -> Dict[str, object]:
    """The exec / P90 / energy columns of ``predict_matrix`` in float32,
    as K1 builds them from the raw state (K2's inputs), with the other
    columns at float32."""
    f32 = np.float32
    with np.errstate(invalid="ignore", over="ignore"):
        exec_s = np.where(c["ewma_n"] >= 3, c["ewma_v"].astype(f32),
                          c["analytic_s"].astype(f32))
        p90 = np.where(c["resp_n"] >= 10, c["resp_h2"].astype(f32),
                       exec_s * f32(1.5))
        energy = (exec_s * c["nodes"].astype(f32)) * \
            c["loaded_w"].astype(f32)
    return {"exec_s": exec_s, "data_s": c["data_s"].astype(f32),
            "p90_s": p90, "energy_j": energy, "alive": c["alive"],
            "unloaded": c["unloaded"], "slo_s": c["slo_s"].astype(f32),
            "energy_weight": c["energy_weight"]}
