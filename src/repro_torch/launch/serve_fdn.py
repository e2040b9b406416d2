"""End-to-end FDN serving (the paper's kind of deployment).

Builds the heterogeneous Function Delivery Network — five target platforms
from small edge boxes to a full pod — deploys both the paper's benchmark
functions and ML-serving functions for the assigned architectures, then
drives a mixed workload through the Gateway and prints where the FDN
delivered every function, the SLO outcomes, and the per-platform energy.

    PYTHONPATH=src python -m repro_torch.launch.serve_fdn \\
        [--backend numpy|torch|auto] [--kernel] [--device D]

Hedging and predictive prewarming are on, and every invocation is admitted
one at a time through ``Gateway.request``, each one decided by the
SLO-composite policy. ``--backend`` picks the decision backend (``auto``:
torch for decisions over at least ``TORCH_DECIDE_MIN`` distinct functions,
numpy below; each decision here is of one function). ``--kernel`` routes
the torch backend's composite decision through the CUDA kernel K1.
``--device`` is where the torch backend, the function bodies and the store
objects live: the CUDA card unless ``cpu`` is asked for; without a card the
run stops with an error naming it.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

from repro_torch.core import FDNControlPlane, Gateway, SLOCompositePolicy
from repro_torch.core import functions as fn_mod
from repro_torch.core import profiles
from repro_torch.core import scheduler as sched
from repro_torch.core.deployment import DeploymentGenerator
from repro_torch.core.loadgen import attach_completion_hooks, run_load
from repro_torch.core.types import SLO, DeploymentSpec
from repro_torch.device import DeviceLike, NoCudaDevice, resolve
from repro_torch.kernels import policy_score as ps

SERVED_ARCHS = ("qwen3-0.6b", "mixtral-8x7b", "llama3-405b")


def run(backend: str = "auto", kernel: bool = False,
        device: DeviceLike = None) -> Dict[str, object]:
    """``examples/serve_fdn.py``'s run. The score backend, score device and
    kernel switch are set for the run and restored after it. Returns the
    numbers ``main`` prints: the decisions by function and platform, each
    platform's served count, P90 and joules, the SLO-satisfying and all
    completions, hedges and redeliveries; beside them the policy's torch
    decisions, K1's launches and the seconds each platform measured for
    each real body."""
    dev = resolve(device)
    with sched.score_settings(backend, dev, kernel):
        cp = FDNControlPlane(enable_hedging=True, predictive_prewarm=True)
        for prof in profiles.TPU_PLATFORMS.values():
            cp.create_platform(prof)

        # the five paper functions + three analytic model-serving functions
        fns = fn_mod.paper_functions(device=dev)
        serve_fns = {a: fn_mod.serving_function(a).replace(slo=SLO(5.0))
                     for a in SERVED_ARCHS}
        all_fns = list(fns.values()) + list(serve_fns.values())
        fn_mod.seed_object_stores(cp.placement, location="hpc-pod",
                                  device=dev)

        spec = DeploymentSpec("fdn-serve", all_fns, list(cp.platforms))
        spec = DeploymentGenerator(cp.kb, cp.events).annotate(spec)
        cp.deploy(spec)
        attach_completion_hooks(cp)
        cp.policy = SLOCompositePolicy(cp.perf, cp.placement)
        gw = Gateway(cp)

        k1 = ps.fused_composite_decide_cuda.launches
        for fn in all_fns:
            run_load(cp.clock, gw.request, fn, vus=4,
                     duration_s=240.0, sleep_s=0.5)
        k1 = ps.fused_composite_decide_cuda.launches - k1

    by_fn: Dict[str, Dict[str, int]] = {}
    for d in cp.kb.decisions:
        by_fn.setdefault(d["fn"], {}).setdefault(d["platform"], 0)
        by_fn[d["fn"]][d["platform"]] += 1
    platforms = {name: {"served": cp.metrics.requests_served(name),
                        "p90_s": cp.metrics.p90_response(name),
                        "joules": cp.energy.joules(name)}
                 for name in cp.platforms}
    met = sum(1 for i in cp.completed
              if i.response_time is not None
              and i.response_time <= i.fn.slo.p90_response_s)
    return {"decisions": by_fn, "platforms": platforms, "slo_met": met,
            "completed": len(cp.completed),
            "hedges": cp.hedge.hedges_sent,
            "redelivered": cp.redeliverer.redelivered,
            "torch_decisions": cp.policy.torch_decisions,
            "k1_launches": k1,
            "measured_s": {name: dict(p.exec_model._measured)
                           for name, p in cp.platforms.items()}}


def report(out: Dict[str, object]) -> str:
    """What ``examples/serve_fdn.py`` prints, from ``run``'s numbers."""
    lines = ["== driving mixed workload through the FDN gateway ==", "",
             f"{'function':>22s} -> platform decisions"]
    for fn, plats in out["decisions"].items():
        top = max(plats, key=plats.get)
        lines.append(f"{fn:>22s} -> {top:14s} ({plats})")
    lines += ["", f"{'platform':>14s} {'served':>7s} {'P90 s':>8s} "
              f"{'joules':>10s}"]
    for name, p in out["platforms"].items():
        lines.append(f"{name:>14s} {p['served']:7d} {p['p90_s']:8.3f} "
                     f"{p['joules']:10.1f}")
    lines += ["", f"SLO-satisfying completions: {out['slo_met']}/"
              f"{out['completed']} hedges={out['hedges']} "
              f"redelivered={out['redelivered']}"]
    return "\n".join(lines) + "\n"


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("numpy", "torch", "auto"),
                    default="auto")
    ap.add_argument("--kernel", action="store_true",
                    help="composite decision through the CUDA kernel K1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        out = run(args.backend, args.kernel, args.device)
    except NoCudaDevice as exc:
        print(f"serve_fdn: {exc}", file=sys.stderr)
        return 2
    sys.stdout.write(report(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
