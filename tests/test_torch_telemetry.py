"""Live telemetry and alerts of the port against the JAX package's on the
same seeded inputs.

* rollup engine units (cascade merge, SLO threshold, retrofit, metric
  filter, ring eviction, auto flush, bounded memory): every series the
  port's engine holds equals the reference engine's, array for array, and
  the reference's invariants hold on the port;
* the burn-rate and health evaluators on synthetic series give the
  reference's event lists;
* the registry's telemetry arms (hpc-outage, overload-ramp, burst-storm,
  smoke-quiet): the port's report equals the reference's byte for byte,
  alerts section included;
* OpenMetrics text equals the reference's byte for byte."""
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import types as jtypes  # noqa: E402
from repro.inspector import registry as jregistry  # noqa: E402
from repro.inspector import run_scenario_state as jrun  # noqa: E402
from repro.obs import alerts as jalerts  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import telemetry as jtel  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.inspector import registry as tregistry  # noqa: E402
from repro_torch.inspector import run_scenario_state as trun  # noqa: E402
from repro_torch.inspector.registry import TELEMETRY_DEFAULTS  # noqa: E402
from repro_torch.obs import alerts as talerts  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402
from repro_torch.obs import telemetry as ttel  # noqa: E402

PKGS = {"repro": (jtel, jalerts), "repro_torch": (ttel, talerts)}
ARMS = ("telemetry/hpc-outage", "telemetry/overload-ramp",
        "telemetry/burst-storm", "telemetry/smoke-quiet")
_RUNS = {}


@pytest.fixture(autouse=True)
def _score_state():
    yield
    tsched.set_score_backend("auto")
    tsched.set_score_device(None)


def arm(name):
    """(reference run, port run) of a registry scenario, each from a fresh
    invocation-id stream."""
    if name not in _RUNS:
        jtypes._inv_counter = itertools.count()
        want = jrun(jregistry.get(name))
        ttypes._inv_counter = itertools.count()
        tsched.set_score_backend("numpy")
        tsched.set_score_device("cpu")
        _RUNS[name] = (want, trun(tregistry.get(name), "cpu"))
    return _RUNS[name]


def both(build):
    """``build(telemetry module, alerts module)`` under each package."""
    return {pkg: build(*mods) for pkg, mods in PKGS.items()}


def assert_same_series(engines):
    j, t = engines["repro"], engines["repro_torch"]
    assert sorted(t.keys()) == sorted(j.keys())
    for key in j.keys():
        for tier in range(len(j.cfg.tiers_s)):
            a = j.get_series(*key, tier=tier)
            b = t.get_series(*key, tier=tier)
            for i, (x, y) in enumerate(zip(a, b)):
                np.testing.assert_array_equal(y, x, err_msg=f"{key} {i}")
    assert t.rollup_summary() == j.rollup_summary()


def _feed(engine, ts, vs):
    engine.observe_many("p", "f", "response_time", ts, vs)
    engine.finalize()
    return engine


# ---------------------------------------------------------------------------
# rollup engine units
# ---------------------------------------------------------------------------

def test_cascade_merge_equals_direct_rollup_and_reference():
    rng = np.random.default_rng(3)
    n = 20_000
    ts = np.sort(rng.uniform(0.0, 600.0, n))
    vs = rng.integers(0, 256, n).astype(float) / 64.0

    def build(tel, _al, tiers):
        return _feed(tel.TelemetryEngine(tel.TelemetryConfig(
            tiers_s=tiers, capacity=1024, auto_flush_samples=None)), ts, vs)

    cascade = both(lambda t, a: build(t, a, (1.0, 10.0, 60.0)))
    direct = both(lambda t, a: build(t, a, (60.0,)))
    assert_same_series(cascade)
    assert_same_series(direct)
    a = cascade["repro_torch"].get_series("p", "f", "response_time", tier=2)
    b = direct["repro_torch"].get_series("p", "f", "response_time", tier=0)
    for i in range(6):
        np.testing.assert_array_equal(a[i], b[i])
    assert int(a[1].sum()) == n
    assert np.all((a[6] >= a[3]) & (a[6] <= a[4]))


def test_slo_threshold_and_retrofit_equal_reference():
    def build(tel, _al):
        eng = tel.TelemetryEngine(tel.TelemetryConfig(
            tiers_s=(1.0,), auto_flush_samples=None))
        eng.observe("p", "g", "response_time", 0.0, 2.0)
        eng.set_slo("f", 0.5)
        eng.set_slo("g", 1.0)              # after its series exists
        ts = np.arange(10, dtype=float) * 0.1
        eng.observe_many("p", "f", "response_time", ts,
                         np.array([0.1] * 6 + [0.9] * 4))
        eng.observe("p", "g", "response_time", 0.5, 2.0)
        eng.finalize()
        return eng

    engines = both(build)
    assert_same_series(engines)
    t = engines["repro_torch"]
    assert int(t.get_series("p", "f", "response_time")[5].sum()) == 4
    assert int(t.get_series("p", "g", "response_time")[5].sum()) == 2


def test_metric_filter_and_health_bypass_equal_reference():
    def build(tel, _al):
        eng = tel.TelemetryEngine(tel.TelemetryConfig(
            metrics=("response_time",), auto_flush_samples=None))
        eng.observe("p", "f", "memory_mb", 0.0, 128.0)
        eng.record_health("p", 0.0, 3.0, 0.5, 40.0)
        eng.finalize()
        return eng

    engines = both(build)
    assert_same_series(engines)
    keys = engines["repro_torch"].keys()
    assert ("p", "f", "memory_mb") not in keys
    assert ("p", ttel.NO_FN, "queue_depth") in keys


def test_ring_eviction_and_auto_flush_equal_reference():
    def evict(tel, _al):
        eng = tel.TelemetryEngine(tel.TelemetryConfig(
            tiers_s=(1.0,), capacity=4, auto_flush_samples=None))
        eng.observe_many("p", "f", "response_time",
                         np.arange(16, dtype=float), np.ones(16))
        eng.flush()
        eng.observe("p", "f", "response_time", 0.5, 1.0)
        eng.flush()
        return eng

    def flush(tel, _al):
        eng = tel.TelemetryEngine(tel.TelemetryConfig(
            tiers_s=(1.0,), auto_flush_samples=64))
        eng.observe_many("p", "f", "response_time",
                         np.linspace(0.0, 9.0, 100), np.ones(100))
        eng.finalize()
        return eng

    for build in (evict, flush):
        assert_same_series(both(build))
    eng = both(evict)["repro_torch"]
    assert eng.dropped_late() == 1
    assert eng.rollup_summary()["samples"] == 17
    assert both(flush)["repro_torch"].flushes >= 1


def test_rollup_memory_is_capacity_bounded_and_equals_reference():
    def build(tel, _al):
        eng = tel.TelemetryEngine(tel.TelemetryConfig(
            tiers_s=(1.0, 10.0, 60.0), capacity=64,
            auto_flush_samples=4096))
        rng = np.random.default_rng(0)
        for start in range(0, 100_000, 10_000):
            ts = np.sort(rng.uniform(start, start + 10_000, 5_000))
            eng.observe_many("p", "f", "response_time", ts,
                             rng.exponential(0.2, 5_000))
        eng.finalize()
        return eng

    engines = both(build)
    assert_same_series(engines)
    sr = engines["repro_torch"].series[("p", "f", "response_time")]
    assert all(len(ring.ids) == 64 for ring in sr.tiers)


# ---------------------------------------------------------------------------
# alert evaluation on synthetic series
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("after", [0.1, 2.0], ids=["healthy", "burning"])
def test_burn_rate_events_equal_reference(after):
    def build(tel, al):
        cfg = al.AlertConfig(slo_target=0.9, rules=(
            al.BurnRule("fast", 5.0, 20.0, 4.0, "page"),),
            min_long_samples=5)
        eng = tel.TelemetryEngine(tel.TelemetryConfig(
            tiers_s=(1.0,), auto_flush_samples=None))
        eng.set_slo("f", 0.5)
        ts = np.arange(0.0, 60.0, 0.1)
        _feed(eng, ts, np.where(ts < 30.0, 0.1, after))
        return al.evaluate_slo_burn(eng, ["f"], cfg)

    events = both(build)
    assert events["repro_torch"] == events["repro"]
    fires = [e for e in events["repro_torch"] if e["kind"] == "fire"]
    assert bool(fires) == (after > 0.5)


@pytest.mark.parametrize("shift", [False, True], ids=["stationary", "shift"])
def test_health_events_equal_reference(shift):
    def build(tel, al):
        cfg = al.AlertConfig(z_threshold=6.0, k_consecutive=3,
                             warmup_buckets=8)
        eng = tel.TelemetryEngine(tel.TelemetryConfig(
            tiers_s=(1.0,), auto_flush_samples=None))
        rng = np.random.default_rng(5)
        for t in range(120):
            depth = 80.0 if shift and t >= 60 else \
                3.0 + rng.normal(0.0, 0.3)
            eng.record_health("plat", float(t), depth,
                              0.4 + rng.normal(0.0, 0.02),
                              35.0 + rng.normal(0.0, 1.0))
        eng.finalize()
        return al.evaluate_health(eng, cfg)

    events = both(build)
    assert events["repro_torch"] == events["repro"]
    fires = [e for e in events["repro_torch"] if e["kind"] == "fire"
             and e["metric"] == "queue_depth"]
    assert bool(fires) == shift
    if shift:
        assert 60.0 <= fires[0]["t"] <= 66.0


# ---------------------------------------------------------------------------
# the registry's telemetry arms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARMS)
def test_telemetry_arm_equals_reference_bytes(name):
    want, got = arm(name)
    assert got.report.to_json() == want.report.to_json()
    a = got.report.alerts
    assert a["enabled"] is True and a["rollup"]["samples"] > 0
    if name == "telemetry/smoke-quiet":
        assert a["slo"]["fires"] == a["health"]["fires"] == 0
    else:
        assert a["health"]["fires"] + a["slo"]["fires"] > 0


def test_outage_detected_within_bounded_window():
    a = arm("telemetry/hpc-outage")[1].report.alerts
    fires = [e for e in a["health"]["events"] if e["kind"] == "fire"]
    assert 40.0 <= min(e["t"] for e in fires) <= 70.0
    assert any(e["platform"] == "hpc-node-cluster" for e in fires)


def test_engine_state_equals_reference():
    want, got = arm("telemetry/hpc-outage")
    assert_same_series({"repro": want.control_plane.telemetry,
                        "repro_torch": got.control_plane.telemetry})


def test_telemetry_does_not_perturb_results():
    tsched.set_score_backend("numpy")
    tsched.set_score_device("cpu")
    sc = tregistry.get("smoke/tiny")
    ttypes._inv_counter = itertools.count()
    plain = json.loads(trun(sc, "cpu").report.to_json())
    ttypes._inv_counter = itertools.count()
    tel = json.loads(trun(sc.replace(telemetry=dict(TELEMETRY_DEFAULTS)),
                          "cpu").report.to_json())
    for rep in (plain, tel):
        rep.pop("alerts", None)
        rep.pop("scenario", None)
    assert tel == plain


# ---------------------------------------------------------------------------
# OpenMetrics exposition
# ---------------------------------------------------------------------------

def test_openmetrics_equals_reference_bytes():
    want, got = arm("telemetry/burst-storm")
    text = texport.to_openmetrics(got.control_plane.telemetry)
    assert text.endswith("# EOF\n") and "fdn_response_time_count" in text
    assert text == jexport.to_openmetrics(want.control_plane.telemetry)


def test_openmetrics_escaping_equals_reference():
    def build(tel, _al):
        eng = tel.TelemetryEngine(tel.TelemetryConfig(
            metrics=("weird.metric-name",)))
        eng.observe_many('p"1\\x', "f\nn", "weird.metric-name",
                         np.array([0.5, 1.0]), np.array([1.0, 2.0]))
        eng.finalize()
        return eng

    engines = both(build)
    text = texport.to_openmetrics(engines["repro_torch"])
    assert 'platform="p\\"1\\\\x"' in text and 'fn="f\\nn"' in text
    assert text == jexport.to_openmetrics(engines["repro"])
