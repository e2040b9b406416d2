"""``launch/trace_serve.summarize`` on synthetic raw profiler events:
overlapping kernels count once in the busy time and in each range's
device time, nested ranges each get the work launched inside them, and a
device copy of a host annotation is no device work; ``engine_readings``
on a stand-in engine."""
import pytest

pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402

from repro_torch.launch import trace_serve  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402


class Event:
    """One raw event as ``kineto_results.events()`` gives it; times in
    microseconds."""

    def __init__(self, name, dev, start, end, corr=0):
        self._v = (name, dev, start, end, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2] * 1000

    def duration_ns(self):
        return (self._v[3] - self._v[2]) * 1000

    def correlation_id(self):
        return self._v[4]


def _events():
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    ev = [Event("engine.decode_step", cpu, 0, 100),
          Event("decode.attend", cpu, 10, 30),
          Event("decode.attend", cpu, 50, 70),
          Event("aten::add", cpu, 12, 14), Event("aten::mm", cpu, 45, 46),
          Event("aten::cat", cpu, 150, 151),
          # a device copy of a host annotation: no launch shares its id
          Event("harness.loop", gpu, 0, 300, 99)]
    # two overlapping kernels of the first attend, one of the step alone,
    # one of the second attend, one outside every range
    for corr, (t, s, e) in enumerate([(11, 12, 25), (21, 20, 40),
                                      (44, 45, 50), (51, 55, 80),
                                      (150, 200, 210)], 1):
        ev += [Event("cudaLaunchKernel", cpu, t, t + 1, corr),
               Event(f"k{corr}", gpu, s, e, corr)]
    return ev


def test_union_us():
    assert trace_serve.union_us([]) == 0
    assert trace_serve.union_us([(0, 10), (5, 20), (30, 40), (32, 35)]) == 30


def test_summarize_takes_unions_over_nested_ranges():
    out = trace_serve.summarize(_events(), wall_s=100e-6,
                                traced_wall_s=120e-6)
    r = out["ranges"]
    assert out["device_busy_ms"] == pytest.approx((28 + 5 + 25 + 10) / 1e3)
    assert out["device_idle_share"] == pytest.approx(1 - 68 / 100)
    assert r["decode.attend"]["calls"] == 2
    assert r["decode.attend"]["host_ms"] == pytest.approx(40 / 1e3)
    assert r["decode.attend"]["device_ms"] == pytest.approx(53 / 1e3)
    assert r["engine.decode_step"]["device_ms"] == pytest.approx(58 / 1e3)
    assert r["decode.attend"]["launches"] == 3
    assert r["engine.decode_step"]["launches"] == 4
    assert r["decode.attend"]["ops"] == 1
    assert r["engine.decode_step"]["ops"] == 2
    assert out["outside_ranges"] == {"launches": 1,
                                     "device_ms": pytest.approx(0.010)}
    assert out["attend_share"] == pytest.approx(53 / 58)
    assert out["moe_share"] is None                     # never entered
    assert [k["name"] for k in out["top_kernels"]][:2] == ["k4", "k2"]


class _Engine:
    """What ``engine_readings`` reads of a ``ServingEngine``."""

    def __init__(self, steps, keys_live, B=2, cap=192):
        self.B, self.cap = B, cap
        self._st = {"decode_steps": steps, "keys_live": keys_live}

    def stats(self):
        return self._st


def _req(submitted, admitted):
    return Request(rid=0, prompt=[1], max_new_tokens=1,
                   submitted_s=submitted, admitted_s=admitted)


@pytest.mark.parametrize("steps,live,stamps,keys,wait", [
    (4, 215, [(0.0, 0.0), (1.0, 1.5), (2.0, 4.0), (3.0, None)],
     215 / (4 * 2 * 192), 0.5 + 0.8 * 1.5),
    (0, 0, [(0.0, None)], None, None)])
def test_engine_readings(steps, live, stamps, keys, wait):
    """useful_keys is the live keys over steps x B x cap; the queue wait's
    p90 is over the admitted requests alone; None where nothing was
    decoded or admitted."""
    reqs = [_req(s, a) for s, a in stamps]
    out = trace_serve.engine_readings(_Engine(steps, live), reqs)
    assert out == {"useful_keys": pytest.approx(keys),
                   "queue_wait_p90_s": pytest.approx(wait)}
