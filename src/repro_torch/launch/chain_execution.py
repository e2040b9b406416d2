"""Function chains end to end: plan a chain with the data-gravity
planner, execute it collaboratively across platforms, inspect the A/B.

Walkthrough in three acts:

 1. Build an FDN over two platforms and plan the ``ab-dual-source``
    chain in every mode — watch the assignment change with the WAN
    bandwidth (co-location vs collaborative split, paper §3.1.3/§5.1.4).
 2. Execute one instance through the control plane and follow the
    intermediates through the object stores.
 3. Run the registered ``chains/split-vs-colocate-ab`` scenario and
    print the per-chain report section: the split arm wins end-to-end
    p90 on a fast interconnect, the co-located arm wins on a slow WAN.

    PYTHONPATH=src python -m repro_torch.launch.chain_execution [--device D]

The planner scores on the host and every stage is released to its planned
platform, so the walkthrough makes no policy decision and has no decision
backend to choose. ``--device`` is where the function bodies and the store
objects live: the CUDA card unless ``cpu`` is asked for; without a card the
run stops with an error naming it.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from repro_torch.chains import DataGravityPlanner, catalog
from repro_torch.core import profiles as prof_mod
from repro_torch.core.control_plane import FDNControlPlane
from repro_torch.core.scheduler import PerformanceRankedPolicy
from repro_torch.core.types import DeploymentSpec
from repro_torch.device import DeviceLike, NoCudaDevice, resolve
from repro_torch.inspector import run_scenario
from repro_torch.inspector.registry import split_vs_colocate

PAIR = ("cloud-cluster", "old-hpc-node-cluster")


def build(bw: float):
    cp = FDNControlPlane()
    for name in PAIR:
        cp.create_platform(prof_mod.PAPER_PLATFORMS[name])
    cp.policy = PerformanceRankedPolicy(cp.perf)
    cp.placement.set_bandwidth(*PAIR, bw)
    tmpl = catalog.get("ab-dual-source")
    fns = dict(tmpl.functions)
    cp.deploy(DeploymentSpec("chains", list(fns.values()), list(PAIR)))
    for inp in tmpl.inputs:
        cp.placement.stores[inp.location].put(inp.key, inp.size_bytes)
    return cp, fns, tmpl


def act1_planning():
    print("== 1. planning: the same chain under two interconnects ==")
    for bw, tag in ((2e9, "fast 2 GB/s"), (3e6, "slow 3 MB/s")):
        cp, fns, tmpl = build(bw)
        planner = DataGravityPlanner(cp.policy, cp.placement, fns)
        plats = [cp.platforms[n] for n in PAIR]
        for mode in ("colocate", "split", "auto"):
            plan = planner.plan(tmpl.chain, plats, mode=mode)
            short = {s: p.split("-")[0] for s, p in plan.assignment.items()}
            print(f"  {tag:12s} {mode:9s} -> {plan.mode:9s} {short} "
                  f"est_makespan={plan.est_makespan_s:.2f}s "
                  f"est_transfer={plan.est_transfer_s:.2f}s")


def act2_execution():
    print("\n== 2. one instance through the control plane ==")
    cp, fns, tmpl = build(2e9)
    planner = DataGravityPlanner(cp.policy, cp.placement, fns)
    ex = cp.chain_executor(fns)
    plan = planner.plan(tmpl.chain,
                        [cp.platforms[n] for n in PAIR], mode="auto")
    inst = ex.launch(tmpl.chain, plan, label="demo")
    cp.clock.run_until(600.0)
    print(f"  status={inst.status} latency={inst.latency:.3f}s "
          f"stages={inst.stages_done}/{tmpl.chain.n_stages}")
    print(f"  bytes moved across platforms: {inst.bytes_moved / 1e6:.1f} "
          f"MB ({inst.transfer_s:.3f}s of transfer)")
    print(f"  stage invocations completed: {cp.completed_count}")


def act3_scenario_ab(device: DeviceLike):
    print("\n== 3. split-vs-colocate A/B scenarios ==")
    for sc, tag in ((split_vs_colocate(2e9), "fast WAN"),
                    (split_vs_colocate(3e6, rps=1.0, suffix="-slowwan"),
                     "slow WAN")):
        rep = run_scenario(sc, device)
        split = rep.per_chain["ab@split"]
        coloc = rep.per_chain["ab@colocate"]
        winner = "split" if split["p90_s"] < coloc["p90_s"] else "colocate"
        print(f"  {tag}: split_p90={split['p90_s']:.2f}s "
              f"colocate_p90={coloc['p90_s']:.2f}s -> {winner} wins "
              f"(split moved {split['bytes_moved'] / 1e9:.2f} GB)")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        dev = resolve(args.device)
    except NoCudaDevice as exc:
        print(f"chain_execution: {exc}", file=sys.stderr)
        return 2
    act1_planning()
    act2_execution()
    act3_scenario_ab(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
