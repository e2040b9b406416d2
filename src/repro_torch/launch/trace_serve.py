"""Where the serving time goes on the card: one serving run traced with
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.trace_serve [--arch ARCH]

The workload is chip_smoke.py's serving phase, ``launch.serve.workload``:
``--arch`` (qwen3-0.6b, mamba2-2.7b or recurrentgemma-9b; default
qwen3-0.6b) at full width, bf16, random weights from seed 0, prefill through
the CUDA kernels, batch 4, context 1024, 16 requests of 64-1000 prompt
tokens and 32 new tokens each. After a two-request warm-up it runs once
untraced and once traced, and prints one JSON line:

* ``wall_s`` / ``traced_wall_s``: the two runs' wall times (their difference
  is what the tracing costs);
* per engine range (``engine.prefill``, ``engine.decode_step``): calls, host
  milliseconds inside the range, PyTorch ops called directly in it, kernel
  launches issued from it, and device milliseconds of the work it issued
  (kernels, copies and sets that run inside the range's device-side
  annotation), in total and per call;
* the device's busy milliseconds and its idle share of the untraced wall
  time (busy time is the same with and without the profiler; wall time is
  not);
* the kernels that took the most device time.

It needs the card and stops with an error naming it when there is none.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import device as devmod
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import run_timed, workload
from repro_torch.models import model_api as api

REQUESTS = 16
RANGES = ("engine.prefill", "engine.decode_step")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx")


def _spans(events, device_type):
    """The engine's ranges on one timeline, sorted by start. A
    ``record_function`` range appears on the host timeline and, as a user
    annotation, on the device timeline too."""
    spans = sorted((e for e in events if e.name in RANGES
                    and e.device_type == device_type),
                   key=lambda e: e.time_range.start)
    return spans, [e.time_range.start for e in spans]


def _containing(spans, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t <= spans[i].time_range.end:
        return spans[i].name
    return None


def summarize(events, wall_s: float, traced_wall_s: float) -> dict:
    host, host_starts = _spans(events, DeviceType.CPU)
    dev, dev_starts = _spans(events, DeviceType.CUDA)
    per_range = {n: {"calls": 0, "host_ms": 0.0, "ops": 0, "launches": 0,
                     "device_ms": 0.0} for n in RANGES}
    for e in host:
        per_range[e.name]["calls"] += 1
        per_range[e.name]["host_ms"] += e.time_range.elapsed_us() / 1e3
    by_kernel = defaultdict(lambda: [0.0, 0])
    outside = {"launches": 0, "device_ms": 0.0}
    for e in events:
        if e.name in RANGES:
            continue
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            by_kernel[e.name][0] += ms
            by_kernel[e.name][1] += 1
            name = _containing(dev, dev_starts, e.time_range.start)
            (per_range[name] if name else outside)["device_ms"] += ms
            continue
        parent = e.cpu_parent
        if parent is not None and parent.name in RANGES:
            per_range[parent.name]["ops"] += 1
        if e.name in LAUNCHES:
            name = _containing(host, host_starts, e.time_range.start)
            (per_range[name] if name else outside)["launches"] += 1
    for r in per_range.values():
        for k in ("host_ms", "ops", "launches", "device_ms"):
            r[k + "_per_call"] = r[k] / max(r["calls"], 1)
    busy_ms = sum(v[0] for v in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "wall_s": wall_s, "traced_wall_s": traced_wall_s,
        "ranges": per_range, "outside_ranges": outside,
        "device_busy_ms": busy_ms if by_kernel else None,
        "device_idle_share": (1 - busy_ms / (wall_s * 1e3)
                              if by_kernel else None),
        "top_kernels": [{"name": n[:80], "ms": v[0], "count": v[1]}
                        for n, v in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=("qwen3-0.6b", "mamba2-2.7b",
                             "recurrentgemma-9b"))
    args = ap.parse_args(argv)
    try:
        dev = devmod.resolve(None)
    except devmod.NoCudaDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg = get_config(args.arch).replace(use_pallas=True)
    params = api.init_params(cfg, devmod.generator(0, dev), dev)
    run_timed(*workload(cfg, params, 2, seed=1))         # warm-up
    wall_s = run_timed(*workload(cfg, params, REQUESTS))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_wall_s = run_timed(*workload(cfg, params, REQUESTS))
    print(json.dumps({"arch": cfg.name, "requests": REQUESTS,
                      **summarize(prof.events(), wall_s, traced_wall_s)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
