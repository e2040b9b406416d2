"""Warm-pool controller throughput and the prewarm-policy A/B
(repro_torch.autoscale), as ``benchmarks/bench_autoscale.py`` of the JAX
package runs them.

Two measurements:

  * ``tick throughput`` — controller ticks/second over the five Table-3
    platforms x the Table-2 function mix (25 managed rows) under the
    predictive forecaster, with an arrival burst landing every 8th tick:
    the mixed steady state the dormant fast-forward and cached-decision
    paths are built for.  The full run pins >= 1e5 ticks/s when the
    forecaster ticks on NumPy (the pin of the JAX package's benchmark);
    a torch forecaster pays one round trip to its device per arrival tick
    and is reported without a pin;
  * ``policy A/B`` — the registry's prewarm-policy studies, asserting the
    energy-vs-SLO trade-off in both directions (seed-deterministic):
      - diurnal deep-trough trace: predictive prewarming beats the fixed
        60 s keep-alive on cold-start rate at equal-or-lower idle Wh;
      - sparse trace: scale-to-zero wins idle Wh but pays for it in p99;
      - MMPP burst trace: predictive holds equal-or-lower idle Wh.

The full run also checks that the NumPy and torch forecasters make
byte-identical prewarm decisions on a seeded arrival stream.

    PYTHONPATH=src python -m repro_torch.launch.bench_autoscale \\
        [--smoke] [--backend numpy|torch|auto] [--device D] [--json PATH]

``--backend`` picks the forecaster's backend (``auto``: torch at
``TORCH_FORECAST_MIN`` managed rows or more, so NumPy at these 25 rows).
``--device`` is where the torch forecaster computes: the CUDA card unless
``cpu`` is asked for; without a card the run stops with an error naming
it.  ``--smoke`` runs fewer ticks and only the sparse A/B.  Prints
``name,us_per_call,derived`` rows, then one JSON line of the measurements
(also written to ``--json PATH`` when given); exits 1 when a check fails.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.autoscale import (PredictivePolicy, WarmPoolController,
                                   forecast, make_policy)
from repro_torch.core import FDNControlPlane
from repro_torch.core import functions as fn_mod
from repro_torch.core import profiles
from repro_torch.core.types import DeploymentSpec
from repro_torch.device import DeviceLike, NoCudaDevice, resolve
from repro_torch.inspector import registry, run_scenario

FULL_TICKS = 200_000
SMOKE_TICKS = 50_000
ARRIVAL_EVERY = 8
TICKS_PER_S_PIN = 1e5


def _plane(device: DeviceLike) -> FDNControlPlane:
    """The five Table-3 platforms with the Table-2 functions deployed,
    analytic (no function body runs): the control loop alone."""
    cp = FDNControlPlane()
    for prof in profiles.PAPER_PLATFORMS.values():
        cp.create_platform(prof)
    fns = [f.replace(real_fn=None)
           for f in fn_mod.paper_functions(device=device).values()]
    cp.deploy(DeploymentSpec("fdninspector", fns, list(cp.platforms)))
    return cp


def bench_ticks(n_ticks: int, reps: int, device: DeviceLike = None
                ) -> Tuple[float, int, int]:
    """(ticks/s best-of-reps, managed rows, torch forecaster ticks): drives
    ``controller.tick`` directly with a synthetic admission stream
    (counters written the way the platforms write them)."""
    cp = _plane(device)
    ctl = WarmPoolController(cp.platforms, cp.perf, cp.clock,
                             make_policy("predictive"), tick_s=1.0).attach()
    clock = cp.clock
    p0 = next(iter(cp.platforms.values()))
    for _ in range(256):                   # settle pools / warm caches
        clock._t += 1.0
        ctl.tick()
    best = float("inf")
    for _ in range(reps):
        gc.collect()                       # outside the timed region
        t0 = time.perf_counter()
        for i in range(n_ticks):
            clock._t += 1.0
            if i % ARRIVAL_EVERY == 0:
                c = p0.autoscale_counts
                c["nodeinfo"] = c.get("nodeinfo", 0) + 5
            ctl.tick()
        best = min(best, time.perf_counter() - t0)
    return n_ticks / best, ctl._rows, ctl.policy.torch_ticks


def run_ab(name: str, device: DeviceLike = None) -> Dict[str, float]:
    t = run_scenario(registry.get(name), device).totals
    return {"cold_start_rate": t["cold_start_rate"],
            "cold_starts": t["cold_starts"], "idle_wh": t["idle_wh"],
            "p99_s": t["p99_s"], "completed": t["completed"],
            "autoscale_ticks": t["autoscale"]["ticks"]}


def decisions(backend: str, rows: int = 12, ticks: int = 400,
              seed: int = 7) -> List[Tuple[list, list]]:
    """Prewarm decisions of a forecaster on the JAX package's seeded
    parity stream."""
    rng = np.random.default_rng(seed)
    streams = rng.poisson(2.0, size=(ticks, rows)) * \
        (rng.random(size=(ticks, rows)) < 0.3)
    exec_s = rng.uniform(0.01, 0.5, rows)
    pol = PredictivePolicy(backend=backend)
    pol.resize(rows)
    pol.set_exec(exec_s, 1.0)
    out = []
    for k in range(ticks):
        counts = streams[k].astype(float)
        desired, ttl = pol.tick(counts, bool(counts.any()))
        out.append((desired.astype(int).tolist(),
                    np.asarray(ttl).astype(int).tolist()))
    return out


def check(cond: bool, msg: str, failures: List[str]) -> bool:
    if not cond:
        failures.append(msg)
    return cond


def run(smoke: bool = False, backend: str = "auto",
        device: DeviceLike = None) -> Tuple[List[str], Dict, List[str]]:
    """(CSV rows, measurements, failed checks). The forecaster's backend
    and device are set for the run and restored after it."""
    dev = resolve(device)
    rows: List[str] = []
    failures: List[str] = []
    n_ticks = SMOKE_TICKS if smoke else FULL_TICKS
    reps = 2 if smoke else 3
    with forecast.forecast_settings(backend, dev):
        ticks_per_s, n_rows, torch_ticks = bench_ticks(n_ticks, reps, dev)
        rows.append(f"autoscale/tick_throughput,{1e6 / ticks_per_s:.1f},"
                    f"ticks_per_s={ticks_per_s:.0f};rows={n_rows};"
                    f"arrival_every={ARRIVAL_EVERY};best_of={reps};"
                    f"torch_ticks={torch_ticks}")
        if not smoke and torch_ticks == 0:
            check(ticks_per_s >= TICKS_PER_S_PIN,
                  f"controller should sustain >= {TICKS_PER_S_PIN:.0e} "
                  f"ticks/s (got {ticks_per_s:.0f})", failures)

        ab: Dict[str, Dict[str, float]] = {}
        arms = ["sparse-ttl", "sparse-scale-to-zero"]
        if not smoke:
            arms += ["diurnal-ttl", "diurnal-predictive",
                     "burst-ttl", "burst-predictive"]
        for arm in arms:
            ab[arm] = s = run_ab(f"autoscale/{arm}", dev)
            rows.append(f"autoscale/{arm},0.0,"
                        f"cold_rate={s['cold_start_rate']:.4f};"
                        f"idle_wh={s['idle_wh']:.4f};"
                        f"p99_s={s['p99_s']:.3f};n={s['completed']}")
    s2z, ttl = ab["sparse-scale-to-zero"], ab["sparse-ttl"]
    check(s2z["idle_wh"] < ttl["idle_wh"],
          "sparse: scale-to-zero should win idle Wh over the fixed TTL",
          failures)
    check(s2z["p99_s"] > ttl["p99_s"],
          "sparse: scale-to-zero should pay for idle Wh with worse p99",
          failures)
    if not smoke:
        pred, ttl = ab["diurnal-predictive"], ab["diurnal-ttl"]
        check(pred["cold_start_rate"] < ttl["cold_start_rate"],
              "diurnal: predictive prewarming should beat the fixed TTL "
              "on cold-start rate", failures)
        check(pred["idle_wh"] <= ttl["idle_wh"],
              "diurnal: predictive should spend equal-or-lower idle Wh "
              "than the fixed TTL", failures)
        check(ab["burst-predictive"]["idle_wh"] <=
              ab["burst-ttl"]["idle_wh"],
              "burst: predictive should hold equal-or-lower idle Wh",
              failures)
        with forecast.forecast_settings("numpy", dev):
            want = decisions("numpy")
        with forecast.forecast_settings("torch", dev):
            got = decisions("torch")
        check(got == want, "the torch forecaster must make byte-identical "
              "prewarm decisions to the NumPy oracle", failures)
    results = {"smoke": smoke, "backend": backend, "device": str(dev),
               "n_ticks": n_ticks, "rows": n_rows,
               "autoscale_ticks_per_s": ticks_per_s,
               "torch_forecaster_ticks": torch_ticks, "ab": ab}
    return rows, results, failures


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--backend", choices=("numpy", "torch", "auto"),
                    default="auto", help="forecaster backend")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--json", default=None,
                    help="also write the measurements to this file")
    args = ap.parse_args(argv)
    try:
        rows, results, failures = run(args.smoke, args.backend, args.device)
    except NoCudaDevice as exc:
        print(f"bench_autoscale: {exc}", file=sys.stderr)
        return 2
    for r in rows:
        print(r)
    results["failures"] = failures
    text = json.dumps(results, sort_keys=True)
    if args.json is not None:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    print(text)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
