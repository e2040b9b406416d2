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
* per program range (``RANGES``: the engine's admission, prefill, decode
  step and retirement, and inside the model each layer's decode attention
  and MoE block; ``repro_torch.ranges``): calls, host milliseconds inside
  the range, operator calls (``aten::``) and kernel launches made inside
  it, nested ones included, and device milliseconds of the work launched
  inside it (the union of the intervals of the kernels, copies and sets
  whose launch lies inside an instance, joined by correlation id), in
  total and per call;
* ``attend_share``: decode attention's device time over the decode step's,
  and ``moe_share``: the MoE blocks' over the device's busy time;
* the device's busy milliseconds (the union of its operations' intervals,
  so that overlapping ones count once) and its idle share of the untraced
  wall time (busy time is the same with and without the profiler; wall
  time is not);
* the kernels that took the most device time;
* from the engine alone, for the untraced run (``engine_readings``):
  ``useful_keys``, the share of the keys the decode steps' attention read
  that were live, not padding, and ``queue_wait_p90_s``, the 90th
  percentile of the requests' waits from submission to admission.

The profiler's raw events (``kineto_results.events()``) are read once; its
per-event objects are never built.

It needs the card and stops with an error naming it when there is none.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict

import numpy as np
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import device as devmod
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import run_timed, workload
from repro_torch.models import model_api as api

REQUESTS = 16
RANGES = ("engine.admit", "engine.prefill", "engine.decode_step",
          "engine.retire", "decode.attend", "layer.moe")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx")


def _inside(spans, t) -> bool:
    """Whether ``t`` lies in one of the sorted, disjoint ``spans``."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and t <= spans[i][1]


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _share(ranges, part, whole):
    """``part``'s device time over ``whole``; None where ``part`` was never
    entered or ``whole`` is 0."""
    r = ranges[part]
    return r["device_ms"] / whole if r["calls"] and whole else None


def summarize(events, wall_s: float, traced_wall_s: float) -> dict:
    """The JSON line's numbers from the raw events of a stopped profile.
    Ranges nest (``decode.attend`` inside ``engine.decode_step``); the
    instances of one range do not. A device operation is a device event
    launched by a host call into the CUDA runtime or driver (the two share
    a correlation id); its launch's time places it in the ranges."""
    host = {n: [] for n in RANGES}
    runtime, device = {}, []          # runtime: correlation id -> host time
    aten, launches = [], []
    for ev in events:
        name, start = ev.name(), ev.start_ns() / 1e3
        end = start + ev.duration_ns() / 1e3
        if ev.device_type() == DeviceType.CUDA:
            device.append((name, start, end, ev.correlation_id()))
        elif name in RANGES:
            host[name].append((start, end))
        elif name.startswith("cu"):
            runtime[ev.correlation_id()] = start
            if name in LAUNCHES:
                launches.append(start)
        elif name.startswith("aten::"):
            aten.append(start)
    host = {n: sorted(v) for n, v in host.items()}
    per_range = {n: {"calls": len(v), "host_ms": sum(
        e - s for s, e in v) / 1e3} for n, v in host.items()}
    for n, r in per_range.items():
        r["ops"] = sum(_inside(host[n], t) for t in aten)
        r["launches"] = sum(_inside(host[n], t) for t in launches)
    by_kernel = defaultdict(lambda: [0.0, 0])
    ops, outside_ops = [], []
    in_range = {n: [] for n in RANGES}
    for name, s, e, corr in device:
        t = runtime.get(corr)
        if t is None:
            continue                  # a device copy of a host annotation
        by_kernel[name][0] += (e - s) / 1e3
        by_kernel[name][1] += 1
        ops.append((s, e))
        names = [n for n in RANGES if _inside(host[n], t)]
        for n in names:
            in_range[n].append((s, e))
        if not names:
            outside_ops.append((s, e))
    for n, r in per_range.items():
        r["device_ms"] = union_us(in_range[n]) / 1e3
        for k in ("host_ms", "ops", "launches", "device_ms"):
            r[k + "_per_call"] = r[k] / max(r["calls"], 1)
    busy_ms = union_us(ops) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "wall_s": wall_s, "traced_wall_s": traced_wall_s,
        "ranges": per_range,
        "outside_ranges": {
            "launches": sum(not any(_inside(v, t) for v in host.values())
                            for t in launches),
            "device_ms": union_us(outside_ops) / 1e3},
        "attend_share": _share(per_range, "decode.attend",
                               per_range["engine.decode_step"]["device_ms"]),
        "moe_share": _share(per_range, "layer.moe", busy_ms),
        "device_busy_ms": busy_ms if ops else None,
        "device_idle_share": (1 - busy_ms / (wall_s * 1e3)
                              if ops else None),
        "top_kernels": [{"name": n[:80], "ms": v[0], "count": v[1]}
                        for n, v in top],
    }


def engine_readings(eng, reqs) -> dict:
    """``useful_keys`` and ``queue_wait_p90_s`` of one run of ``reqs`` on
    ``eng``, from the engine's counters and stamps; None where the run
    decoded nothing or admitted no request."""
    read = eng.stats()["decode_steps"] * eng.B * eng.cap
    waits = [r.admitted_s - r.submitted_s for r in reqs
             if r.admitted_s is not None]
    return {"useful_keys": eng.stats()["keys_live"] / read if read else None,
            "queue_wait_p90_s": float(np.percentile(waits, 90))
            if waits else None}


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
    eng, reqs = workload(cfg, params, REQUESTS)
    wall_s = run_timed(eng, reqs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_wall_s = run_timed(*workload(cfg, params, REQUESTS))
    print(json.dumps({"arch": cfg.name, "requests": REQUESTS,
                      **summarize(prof.profiler.kineto_results.events(),
                                 wall_s, traced_wall_s),
                      **engine_readings(eng, reqs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
