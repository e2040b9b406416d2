"""What the per-layer metrics read from a ``torch.profiler`` trace of part
of the window: the program's own ranges (``engine.prefill``,
``engine.decode_step``), the harness's ``harness.loop`` range around each
pass of its loop, and the device's operations.

The raw events (``kineto_results.events()``) are read once into plain
tuples; the profiler's own per-event objects are never built (over a
window of eager decode steps they take minutes).

* busy: the union of the device's operation intervals (kernels, copies,
  sets), so that overlapping operations count once;
* a range's device extent: from the first start to the last end of the
  operations launched from inside one instance of the range (the launch's
  runtime call and the operation share a correlation id), summed over
  instances;
* idle gaps: the stretches between busy intervals, each labelled by the
  innermost host range open when it began.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

RANGES = ("engine.prefill", "engine.decode_step", "harness.loop")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
K3 = "flash_fwd"


@dataclass
class Trace:
    window_ns: Tuple[int, int]
    host: Dict[str, List[Tuple[int, int]]]          # range -> intervals
    ops: List[Tuple[str, int, int, int]]            # name, start, end, corr
    launch_ns: Dict[int, int]                       # corr -> host time
    extra: Dict[str, float] = field(default_factory=dict)

    # ------------------------------------------------------------ device --
    def busy_intervals(self) -> List[Tuple[int, int]]:
        lo, hi = self.window_ns
        merged: List[List[int]] = []
        for _, s, e, _ in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def op_seconds(self, needle: str) -> float:
        return sum(e - s for n, s, e, _ in self.ops if needle in n) / 1e9

    def top_ops(self, k: int = 10) -> List[list]:
        by = defaultdict(int)
        for n, s, e, _ in self.ops:
            by[n] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], v / 1e9] for n, v in top]

    # ------------------------------------------------------------- host ---
    def host_s(self, name: str) -> float:
        return sum(e - s for s, e in self.host.get(name, ())) / 1e9

    def device_extent_s(self, name: str) -> float:
        """Summed device extent of the operations each instance of host
        range ``name`` launched."""
        spans = sorted(self.host.get(name, ()))
        starts = [s for s, _ in spans]
        lo: Dict[int, int] = {}
        hi: Dict[int, int] = {}
        for _, s, e, corr in self.ops:
            t = self.launch_ns.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i < 0 or t > spans[i][1]:
                continue
            lo[i] = min(lo.get(i, s), s)
            hi[i] = max(hi.get(i, e), e)
        return sum(hi[i] - lo[i] for i in lo) / 1e9

    def label_at(self, t: int) -> str:
        """The innermost host range open at ``t`` ("outside" if none)."""
        best, width = "outside", None
        for name in RANGES:
            for s, e in self.host.get(name, ()):
                if s <= t <= e and (width is None or e - s < width):
                    best, width = name, e - s
        return best

    def idle_gaps(self, k: int = 10) -> List[list]:
        lo, hi = self.window_ns
        busy = self.busy_intervals()
        gaps, prev = [], lo
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.label_at(s), (e - s) / 1e9] for s, e in gaps[:k]]


def _kind(ev, on_device: bool, name: str) -> str:
    """The event's activity: the profiler's own word where this PyTorch
    gives it (``activity_type``), else worked out from the device and the
    name (a device-side copy of one of RANGES is a user annotation; a host
    call into the CUDA runtime or driver carries a launch's correlation
    id)."""
    try:
        return str(ev.activity_type())
    except (AttributeError, RuntimeError):
        pass
    if on_device:
        return "gpu_user_annotation" if name in RANGES else "kernel"
    if name in RANGES:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def collect(prof) -> Trace:
    """The trace of a stopped ``torch.profiler.profile``. The traced window
    is the span of the harness's ``harness.loop`` ranges."""
    from torch.autograd import DeviceType

    host: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    ops, launch, kinds = [], {}, defaultdict(int)
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        on_device = ev.device_type() == DeviceType.CUDA
        kind = _kind(ev, on_device, name)
        kinds[kind] += 1
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if on_device:
            if kind in DEVICE_KINDS:
                ops.append((name, start, end, ev.correlation_id()))
        elif kind in LAUNCH_KINDS:
            launch[ev.correlation_id()] = start
        elif name in RANGES:
            host[name].append((start, end))
    loops = host.get("harness.loop", [])
    if not loops:
        raise RuntimeError("the trace holds no harness.loop range")
    window = (min(s for s, _ in loops), max(e for _, e in loops))
    tr = Trace(window, dict(host), ops, launch)
    tr.extra = {f"events.{k}": v for k, v in kinds.items()}
    tr.extra["ops_launched_seen"] = sum(1 for o in ops if o[3] in launch)
    tr.extra["ops"] = len(ops)
    return tr
