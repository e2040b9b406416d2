"""Reproduce the paper's headline energy result (Table 4) and show the FDN
making the energy-aware decision automatically.

    PYTHONPATH=src python -m repro_torch.launch.energy_aware_scheduling \\
        [--backend numpy|torch|auto] [--device D]

Table 4 runs JSON-loads alone on the edge cluster and alone on the HPC node
cluster at 40 requests/s for 300 simulated seconds; then the energy-aware
policy chooses a platform for JSON-loads and for primes-python under a 5 s
SLO. ``--backend`` picks the backend of those two decisions (``auto``:
torch for decisions over at least ``TORCH_DECIDE_MIN`` distinct functions,
numpy below; each decision here is of one function); the energy-aware
policy's torch decision is ``policy_score.energy_decide``. ``--device`` is where the torch backend, the function bodies and the store
objects live: the CUDA card unless ``cpu`` is asked for; without a card the
run stops with an error naming it.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

from repro_torch.core import EnergyAwarePolicy, FDNControlPlane, Invocation
from repro_torch.core import functions as fn_mod
from repro_torch.core import profiles
from repro_torch.core import scheduler as sched
from repro_torch.core.loadgen import attach_completion_hooks, run_open_loop
from repro_torch.core.types import SLO, DeploymentSpec
from repro_torch.device import DeviceLike, NoCudaDevice, resolve

TABLE4_PLATFORMS = ("edge-cluster", "hpc-node-cluster")
PAPER_RATIO = 16.9


def run_exclusive(pname: str, rps=40.0, duration=300.0,
                  device: DeviceLike = None):
    """JSON-loads alone on ``pname`` at ``rps`` for ``duration`` simulated
    seconds; the function bodies and the seeded store objects on
    ``device``. Returns the open loop's result, the platform's joules and
    the platform's control plane."""
    dev = resolve(device)
    cp = FDNControlPlane()
    cp.create_platform(profiles.PAPER_PLATFORMS[pname])
    fns = fn_mod.paper_functions(device=dev)
    fn_mod.seed_object_stores(cp.placement, location=pname, device=dev)
    cp.deploy(DeploymentSpec("t", list(fns.values()), [pname]))
    attach_completion_hooks(cp)
    res = run_open_loop(cp.clock,
                        lambda i: cp.submit(i, platform_override=pname),
                        fns["JSON-loads"], rps, duration)
    cp.run_until(cp.clock.now())
    return res, cp.energy.joules(pname), cp


def run(backend: str = "auto",
        device: DeviceLike = None) -> Dict[str, object]:
    """``examples/energy_aware_scheduling.py``'s run. The score backend
    and score device are set for the run and restored after it. Returns
    the numbers ``main`` prints: each Table 4 row (served, P90, joules),
    the energy ratio and the policy's two choices; beside them the policy's
    torch decisions and the seconds each Table 4 platform measured
    for the JSON-loads body."""
    dev = resolve(device)
    rows, measured = {}, {}
    with sched.score_settings(backend, dev, False):
        for pname in TABLE4_PLATFORMS:
            res, j, cp = run_exclusive(pname, device=dev)
            rows[pname] = {"served": len(res.completed),
                           "p90_s": res.p90_response(), "joules": j}
            measured[pname] = dict(cp.platforms[pname].exec_model._measured)

        cp = FDNControlPlane()
        for pname in TABLE4_PLATFORMS:
            cp.create_platform(profiles.PAPER_PLATFORMS[pname])
        fns = fn_mod.paper_functions(device=dev)
        fn_mod.seed_object_stores(cp.placement, location="edge-cluster",
                                  device=dev)
        cp.deploy(DeploymentSpec("t", list(fns.values()),
                                 list(cp.platforms)))
        cp.policy = EnergyAwarePolicy(cp.perf)
        json_choice = cp.policy.choose(Invocation(fns["JSON-loads"], 0.0),
                                       cp.alive_platforms())
        strict_primes = fns["primes-python"].replace(slo=SLO(5.0))
        primes_choice = cp.policy.choose(Invocation(strict_primes, 0.0),
                                         cp.alive_platforms())
    return {"rows": rows,
            "ratio": (rows["hpc-node-cluster"]["joules"]
                      / rows["edge-cluster"]["joules"]),
            "json_loads_choice": json_choice.prof.name,
            "strict_primes_choice": primes_choice.prof.name,
            "torch_decisions": cp.policy.torch_decisions,
            "measured_s": measured}


def report(out: Dict[str, object]) -> str:
    """What ``examples/energy_aware_scheduling.py`` prints, from ``run``'s
    numbers."""
    lines = ["== Table 4: JSON-loads at fixed arrival rate, 300 s =="]
    for pname, r in out["rows"].items():
        lines.append(f"{pname:>20s}: served={r['served']:6d} "
                     f"p90={r['p90_s']:6.3f}s  energy={r['joules']:9.1f} J")
    lines += [f"energy ratio: {out['ratio']:.1f}x (paper: {PAPER_RATIO}x)",
              "", "== the FDN makes this choice automatically ==",
              f"EnergyAwarePolicy routes JSON-loads -> "
              f"{out['json_loads_choice']}",
              f"EnergyAwarePolicy routes primes-python (5 s SLO) -> "
              f"{out['strict_primes_choice']} (edge would violate the SLO)"]
    return "\n".join(lines) + "\n"


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("numpy", "torch", "auto"),
                    default="auto")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        out = run(args.backend, args.device)
    except NoCudaDevice as exc:
        print(f"energy_aware_scheduling: {exc}", file=sys.stderr)
        return 2
    sys.stdout.write(report(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
