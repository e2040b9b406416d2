"""FDNInspector end to end: run one registry scenario, print its report.

A scenario is pure data — platforms, per-function workload mix, policy,
SLOs, faults, seed — and the report is a versioned, canonical-JSON
artifact: run this twice (or on another machine) and the bytes match, and
they match under every decision backend.

    PYTHONPATH=src python -m repro_torch.launch.inspector_scenario \\
        [scenario-name] [--backend numpy|torch|auto] [--kernel] \\
        [--forecast numpy|torch|auto] [--device D] [--list]

Default scenario: mix/five-platform (all five Table-2 functions as
concurrent Poisson streams over all five Table-3 platforms). ``--list``
prints every registered scenario. ``--backend`` picks the decision backend
(``auto``: torch for decisions over at least ``TORCH_DECIDE_MIN`` distinct
functions, numpy below). ``--kernel`` routes the torch backend's composite
decision through the CUDA kernel K1. ``--forecast`` picks the warm-pool
forecaster's backend in scenarios with an autoscaler (``auto``: torch at
``TORCH_FORECAST_MIN`` managed rows or more). ``--device`` is where the
torch backends, the function bodies and the store objects live: the CUDA
card unless ``cpu`` is asked for; without a card the run stops with an
error naming it.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional

from repro_torch.autoscale import forecast
from repro_torch.core import scheduler as sched
from repro_torch.device import DeviceLike, NoCudaDevice, resolve
from repro_torch.inspector import registry, run_scenario_state
from repro_torch.kernels import policy_score as ps


def run(name: str, backend: str = "auto", kernel: bool = False,
        device: DeviceLike = None, forecast_backend: str = "auto"
        ) -> Dict[str, object]:
    """One registry scenario under one decision backend and one forecaster
    backend. The score and forecast backends, their device and the kernel
    switch are set for the run and restored after it. Returns the wall
    seconds, the report, the run's state, the policy's torch decisions, the
    forecaster's torch ticks and K1's launches in the run."""
    dev = resolve(device)
    sc = registry.get(name)
    with sched.score_settings(backend, dev, kernel), \
            forecast.forecast_settings(forecast_backend, dev):
        k1 = ps.fused_composite_decide_cuda.launches
        t0 = time.perf_counter()
        state = run_scenario_state(sc, dev)
        wall = time.perf_counter() - t0
        k1 = ps.fused_composite_decide_cuda.launches - k1
    cp = state.control_plane
    return {"scenario": sc, "wall_s": wall, "report": state.report,
            "state": state, "torch_decisions": cp.policy.torch_decisions,
            "torch_ticks": (0 if cp.autoscaler is None
                            else cp.autoscaler.policy.torch_ticks),
            "k1_launches": k1}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", nargs="?", default="mix/five-platform")
    ap.add_argument("--list", action="store_true",
                    help="print every registered scenario")
    ap.add_argument("--backend", choices=("numpy", "torch", "auto"),
                    default="auto")
    ap.add_argument("--kernel", action="store_true",
                    help="composite decision through the CUDA kernel K1")
    ap.add_argument("--forecast", choices=("numpy", "torch", "auto"),
                    default="auto", help="warm-pool forecaster backend")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.list:
        for n in registry.names():
            print(n)
        return 0
    try:
        out = run(args.name, args.backend, args.kernel, args.device,
                  args.forecast)
    except NoCudaDevice as exc:
        print(f"inspector_scenario: {exc}", file=sys.stderr)
        return 2
    sc, rep, wall = out["scenario"], out["report"], out["wall_s"]
    t = rep.totals
    print(f"== scenario {sc.name}: {len(sc.platforms)} platforms, "
          f"{len(sc.workloads)} workload streams, {sc.duration_s:.0f}s "
          f"sim, policy={sc.policy}, seed={sc.seed} ==")
    print(f"wall time            : {wall:.2f}s "
          f"({t['submitted'] / max(wall, 1e-9):.0f} invocations/s "
          f"simulated)")
    print(f"backend              : {args.backend}"
          f"{' + K1' if args.kernel else ''} on {resolve(args.device)}: "
          f"{out['torch_decisions']} torch decisions, "
          f"{out['k1_launches']} K1 launches, "
          f"{out['torch_ticks']} torch forecaster ticks")
    print(f"submitted/completed  : {t['submitted']} / {t['completed']} "
          f"(rejected {t['rejected']})")
    print(f"P50 / P90 / P99      : {t['p50_s']:.3f} / {t['p90_s']:.3f} / "
          f"{t['p99_s']:.3f} s")
    print(f"SLO violation rate   : {100 * t['slo_violation_rate']:.2f}%")
    print(f"cold starts          : {t['cold_starts']}")
    print(f"energy               : {t['energy_wh']:.2f} Wh")
    print(f"decisions / sim-s    : {t['decisions_per_sim_s']:.0f}")
    print("per platform         :")
    for pname, s in rep.per_platform.items():
        print(f"  {pname:>22s} n={s['completed']:7d} "
              f"p90={s['p90_s']:7.3f}s cold={s['cold_starts']:5d} "
              f"{s['energy_wh']:8.2f} Wh")
    print("per function         :")
    for fname, s in rep.per_function.items():
        print(f"  {fname:>22s} n={s['completed']:7d} "
              f"p90={s['p90_s']:7.3f}s (slo {s['slo_s']:.1f}s, "
              f"viol {100 * s['slo_violation_rate']:.2f}%)")
    print(f"report               : {len(rep.to_json())} bytes of "
          f"canonical JSON (schema v{rep.schema_version})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
