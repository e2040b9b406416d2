"""The existing per-layer metrics unmoved by the program's inner ranges
(``engine.admit``, ``engine.retire``, ``decode.attend``, ``layer.moe``) in
a trace, and the clock the profiler stamps its events on."""
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, loop, trace
from portbench.test_portbench_flops import DENSE


class Event:
    """One raw event as ``kineto_results.events()`` gives it, on a PyTorch
    that names each event's activity."""

    def __init__(self, name, kind, start, end, corr=0):
        self._v = (name, kind, start, end, corr)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def device_type(self):
        return DeviceType.CUDA if self._v[1] in (
            "kernel", "gpu_user_annotation") else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]


class UntypedEvent(Event):
    """The same on a PyTorch without ``activity_type`` (the card's 2.11)."""

    def activity_type(self):
        raise AttributeError("activity_type")


def events(inner: bool, cls=Event):
    """A loop pass holding a prefill and a decode step, each launching two
    kernels; with ``inner`` the program's inner ranges around them too, on
    the host only, as ``repro_torch.ranges.ranged`` opens them."""
    ev = [cls("harness.loop", "user_annotation", 0, 1000),
          cls("harness.loop", "gpu_user_annotation", 150, 700),
          cls("engine.prefill", "cpu_op", 100, 300),
          cls("engine.decode_step", "cpu_op", 400, 800)]
    for corr, (t, s, e, name) in enumerate(
            [(110, 150, 260, "flash_fwd_wgmma<128>"), (200, 260, 320, "gemm"),
             (420, 450, 600, "elementwise"), (500, 600, 700, "gemm")], 1):
        ev += [cls("cudaLaunchKernel", "cuda_runtime", t, t + 5, corr),
               cls(name, "kernel", s, e, corr)]
    if inner:
        ev += [cls("engine.admit", "cpu_op", 90, 350),
               cls("decode.attend", "cpu_op", 410, 450),
               cls("layer.moe", "cpu_op", 480, 560),
               cls("engine.retire", "cpu_op", 800, 900)]
    return ev


@pytest.mark.parametrize("cls", [Event, UntypedEvent])
def test_existing_readers_unmoved_by_the_inner_ranges(cls):
    bench = harness.load(harness.ROOT / "BENCHMARK.json")
    steps = [loop.Step(0.0, 1.0, [5], [7, 3])]
    got = {}
    for inner in (False, True):
        prof = SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(
                events=lambda: events(inner, cls))))
        run = harness.Run(config=DENSE, trace=trace.collect(prof),
                          traced_steps=steps, served=None)
        got[inner] = {m["name"]: harness.read_metric(m["name"], run)
                      for m in bench["per_layer"]}
    assert got[True] == got[False]
    assert None not in got[False].values()


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_profiler_stamps_ranges_on_the_wall_clock(device):
    """A range's start lies within 5 ms after a ``time.time_ns()`` read
    taken just before it: the profiler's clock is the wall clock, not
    ``time.perf_counter``, on which the client stamps."""
    from torch.profiler import ProfilerActivity, profile, record_function
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    x = torch.ones(1024, device=device)
    with profile(activities=acts) as prof:
        before = time.time_ns()
        with record_function("clock.pin"):
            x.add_(1)
        if device == "cuda":
            torch.cuda.synchronize()
    starts = [ev.start_ns() for ev in prof.profiler.kineto_results.events()
              if ev.name() == "clock.pin"
              and ev.device_type() == DeviceType.CPU]
    assert len(starts) == 1
    assert 0 <= starts[0] - before < 5_000_000


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_program_ranges_stay_on_the_host(device):
    """The program's ranges leave one host event and no device-side copy,
    which ``trace.collect`` would count as a kernel on a PyTorch without
    ``activity_type``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.ranges import ranged
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    x = torch.ones(1024, device=device)
    with profile(activities=acts) as prof:
        with ranged("decode.attend"):
            x.add_(1)
        if device == "cuda":
            torch.cuda.synchronize()
    assert [ev.device_type() for ev in prof.profiler.kineto_results.events()
            if ev.name() == "decode.attend"] == [DeviceType.CPU]
