"""Open-loop burst scheduling through the FDN's batched admission path.

Drives a Poisson arrival storm (default 100,000 invocations of ``nodeinfo``
over 600 simulated seconds, seed 42) through ``Gateway.request_batch`` in
50 ms admission windows: each window's burst is admitted with ONE policy
evaluation (the SLO-composite decision over the paper's five platforms),
and results stream into a columnar sink. Prints one JSON line: wall
seconds, invocations/s, completed, rejected, P90 response, cold starts,
platform shares, the torch backend's decisions and the launches of the
composite-decision kernel (K1).

    PYTHONPATH=src python -m repro_torch.launch.batch_scheduling \\
        [--arrivals N] [--backend numpy|torch|auto] [--kernel] [--device D]

``--backend`` picks the decision backend (``auto``: torch for decisions
over at least ``TORCH_DECIDE_MIN`` distinct functions, numpy below). ``--kernel`` routes the torch backend's
composite decision through the CUDA kernel K1. ``--device`` is where the
torch backend and the function bodies live: the CUDA card unless ``cpu`` is
asked for; without a card the run stops with an error naming it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional

from repro_torch.core import FDNControlPlane, Gateway
from repro_torch.core import functions as fn_mod
from repro_torch.core import profiles
from repro_torch.core import scheduler as sched
from repro_torch.core.loadgen import (ColumnarResultSink, poisson_arrivals,
                                      run_arrivals)
from repro_torch.core.types import DeploymentSpec
from repro_torch.device import DeviceLike, NoCudaDevice, resolve
from repro_torch.kernels import policy_score as ps

DURATION_S = 600.0
BATCH_WINDOW_S = 0.05
SEED = 42


def run(arrivals: int = 100_000, backend: str = "auto",
        kernel: bool = False, device: DeviceLike = None,
        seed: int = SEED) -> Dict[str, object]:
    """One admission stream, as ``examples/batch_scheduling.py`` of the JAX
    package runs it. The score backend, score device and kernel switch are
    set for the run and restored after it. Returns the numbers printed by
    ``main``; ``sink`` and ``cp`` hold the run's sink and control plane."""
    dev = resolve(device)
    with sched.score_settings(backend, dev, kernel):
        cp = FDNControlPlane()
        for prof in profiles.PAPER_PLATFORMS.values():
            cp.create_platform(prof)
        fns = {k: f.replace(real_fn=None)     # analytic: pure scheduling
               for k, f in fn_mod.paper_functions(device=dev).items()}
        fn_mod.seed_object_stores(cp.placement, location="cloud-cluster",
                                  device=dev)
        cp.deploy(DeploymentSpec("burst", list(fns.values()),
                                 list(cp.platforms)))
        gw = Gateway(cp)
        sink = ColumnarResultSink(capacity=arrivals).install(cp)

        fn = fns["nodeinfo"]
        times = poisson_arrivals(arrivals / DURATION_S, DURATION_S,
                                 seed=seed)
        k1 = ps.fused_composite_decide_cuda.launches
        t0 = time.perf_counter()
        run_arrivals(cp.clock, gw.request_batch, fn, times,
                     batch_window_s=BATCH_WINDOW_S, sink=sink)
        wall = time.perf_counter() - t0
        k1 = ps.fused_composite_decide_cuda.launches - k1
    return {"arrivals": int(times.size), "backend": backend,
            "kernel": kernel, "device": str(dev), "seed": seed,
            "wall_s": wall, "invocations_per_s": times.size / wall,
            "completed": sink.completed, "rejected": sink.rejected,
            "p90_response_s": sink.p90_response(),
            "slo_p90_s": fn.slo.p90_response_s,
            "cold_starts": sink.cold_start_count(),
            "platform_counts": dict(sorted(sink.platform_counts().items())),
            "torch_decisions": cp.policy.torch_decisions,
            "k1_launches": k1, "sink": sink, "cp": cp}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arrivals", type=int, default=100_000)
    ap.add_argument("--backend", choices=("numpy", "torch", "auto"),
                    default="auto")
    ap.add_argument("--kernel", action="store_true",
                    help="composite decision through the CUDA kernel K1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        out = run(args.arrivals, args.backend, args.kernel, args.device)
    except NoCudaDevice as exc:
        print(f"batch_scheduling: {exc}", file=sys.stderr)
        return 2
    completed = max(out["completed"], 1)
    out["platform_shares"] = {k: v / completed
                              for k, v in out["platform_counts"].items()}
    del out["sink"], out["cp"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
