"""The autoscale slice: the port's warm-pool controller, keep-alive policies
and forecaster against the JAX package's on the same seeded inputs.

* every keep-alive policy ticks the reference's (desired, TTL) columns
  byte for byte on a seeded arrival stream, dormant stretches included;
* the forecaster's torch backend (on the CPU here; on the card in
  tests/test_torch_cuda.py) makes NumPy's prewarm decisions byte for byte
  on the reference test's seeded stream (seed 3, 9 rows, 300 ticks) and at
  4,096 rows, and the JAX package's jitted tick's decisions too;
* one torch tick against one jitted tick from the same float32 state:
  level, idle counters, histogram, desired pools and TTLs bit-equal; the
  trend within 2 float32 ulps of the larger of its two operands, because
  XLA's CPU backend contracts ``trend + (alpha * beta) * err`` into one
  FMA where torch rounds the product first;
* the gap bucket is exact at every power of two and one below it;
* scenarios with each policy, and the controller's counters, equal the
  reference's, byte for byte."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.autoscale import PredictivePolicy as JPredictive  # noqa: E402
from repro.autoscale import forecast as jforecast  # noqa: E402
from repro.autoscale import make_policy as jmake  # noqa: E402
from repro.core import FDNControlPlane as JPlane  # noqa: E402
from repro.core import profiles as jprof  # noqa: E402
from repro.core.types import DeploymentSpec as JDeploy  # noqa: E402
from repro.core.types import FunctionSpec as JSpec  # noqa: E402
from repro.inspector import Scenario as JScenario  # noqa: E402
from repro.inspector import Workload as JWorkload  # noqa: E402
from repro.inspector import run_scenario_state as jrun  # noqa: E402
from repro.kernels import warm_forecast as jwf  # noqa: E402
from repro_torch import device as devmod  # noqa: E402
from repro_torch.autoscale import (ConcurrencyTargetPolicy,  # noqa: E402
                                   FixedTTLPolicy, PredictivePolicy,
                                   ScaleToZeroPolicy, WarmPoolController,
                                   forecast, make_policy)
from repro_torch.core import FDNControlPlane as TPlane  # noqa: E402
from repro_torch.core import profiles as tprof  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core.types import DeploymentSpec as TDeploy  # noqa: E402
from repro_torch.core.types import FunctionSpec as TSpec  # noqa: E402
from repro_torch.inspector import Scenario as TScenario  # noqa: E402
from repro_torch.inspector import Workload as TWorkload  # noqa: E402
from repro_torch.inspector import run_scenario_state as trun  # noqa: E402
from repro_torch.kernels import warm_forecast as twf  # noqa: E402

# one torch tick's trend against the jitted tick's, in float32 ulps of
# max(|trend|, |alpha * beta * err|) (see the module docstring)
TREND_ULPS = 2.0
STREAMS = {"reference": (3, 9, 300), "rows4096": (5, 4096, 120)}


@pytest.fixture(autouse=True)
def _forecast_on_cpu():
    forecast.set_forecast_device("cpu")
    yield
    forecast.set_forecast_backend("auto")
    forecast.set_forecast_device(None)
    tsched.set_score_backend("auto")
    tsched.set_score_device(None)


def seeded_stream(seed, rows, ticks):
    """tests/test_autoscale.py's seeded arrival stream and exec seconds."""
    rng = np.random.default_rng(seed)
    bursts = rng.poisson(3.0, size=(ticks, rows)) * \
        (rng.random(size=(ticks, rows)) < 0.25)
    return bursts, rng.uniform(0.02, 0.8, rows)


def trajectory(pol, bursts, exec_s):
    """(desired, TTL seconds) bytes after every tick."""
    pol.resize(bursts.shape[1])
    pol.set_exec(exec_s, 1.0)
    out = []
    for k in range(bursts.shape[0]):
        counts = bursts[k].astype(float)
        desired, ttl = pol.tick(counts, bool(counts.any()))
        out.append((desired.tobytes(), np.asarray(ttl).tobytes()))
    return out


# ------------------------------------------------------------ policies ---

def test_make_policy_kinds():
    assert isinstance(make_policy("ttl", ttl_s=10.0), FixedTTLPolicy)
    assert isinstance(make_policy("scale_to_zero"), ScaleToZeroPolicy)
    assert isinstance(make_policy("concurrency"), ConcurrencyTargetPolicy)
    assert isinstance(make_policy("predictive", backend="torch"),
                      PredictivePolicy)
    with pytest.raises(KeyError):
        make_policy("nope")


@pytest.mark.parametrize("kind,kw", [
    ("ttl", {"ttl_s": 12.0}), ("scale_to_zero", {"idle_s": 2.0}),
    ("concurrency", {"target": 2.0}), ("predictive", {"backend": "numpy"}),
    ("predictive", {"backend": None})], ids=lambda v: str(v))
def test_policy_ticks_equal_reference(kind, kw):
    bursts, exec_s = seeded_stream(3, 9, 300)
    assert not bursts[:40].any(axis=1).all()      # dormant ticks included
    want = trajectory(jmake(kind, **kw), bursts, exec_s)
    got = trajectory(make_policy(kind, **kw), bursts, exec_s)
    assert got == want


def test_holt_zero_matrix_and_ttl_from_hist_equal_reference():
    for k in (0, 1, 2, 7, 64, 1000):
        assert forecast.holt_zero_matrix(0.5, 0.3, k) == \
            jforecast.holt_zero_matrix(0.5, 0.3, k)
    rng = np.random.default_rng(11)
    hist = rng.integers(0, 6, size=(64, 12)).astype(float)
    hist[::7] = 0.0
    got = forecast.ttl_from_hist(hist, forecast.ForecastParams())
    want = jforecast.ttl_from_hist(hist, jforecast.ForecastParams())
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------- forecaster ---

@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_torch_forecaster_gives_numpy_decisions(stream):
    bursts, exec_s = seeded_stream(*STREAMS[stream])
    want = trajectory(PredictivePolicy(backend="numpy"), bursts, exec_s)
    pol = PredictivePolicy(backend="torch")
    got = trajectory(pol, bursts, exec_s)
    assert pol.torch_ticks == int(bursts.any(axis=1).sum()) > 0
    assert got == want


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_torch_forecaster_gives_jax_decisions(stream):
    bursts, exec_s = seeded_stream(*STREAMS[stream])
    want = trajectory(JPredictive(backend="jax"), bursts, exec_s)
    got = trajectory(PredictivePolicy(backend="torch"), bursts, exec_s)
    assert got == want


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_one_tick_state_within_ulps_of_jax(stream):
    """Both ticks from the NumPy trajectory's state at every arrival tick,
    as float32 (what the jitted tick takes without x64)."""
    bursts, exec_s = seeded_stream(*STREAMS[stream])
    p = forecast.ForecastParams()
    pol = PredictivePolicy(backend="numpy")
    pol.resize(bursts.shape[1])
    pol.set_exec(exec_s, 1.0)
    scalars = (p.alpha, p.beta, p.min_demand, float(p.max_pool), p.quantile,
               p.default_ttl_ticks, p.min_ttl_ticks, p.max_ttl_ticks,
               float(p.min_gap_obs), pol._hold_thr)
    ab = np.float32(np.float32(p.alpha) * np.float32(p.beta))
    checked = 0
    for k in range(bursts.shape[0]):
        counts = bursts[k].astype(float)
        if counts.any():
            s = pol.state
            cols = [np.asarray(a, np.float32) for a in (
                counts, s.level, s.trend, s.idle_ticks, s.hist, pol._coeff)]
            want = [np.asarray(x) for x in jwf.predictive_tick(
                *cols, *scalars)]
            got = [x.numpy() for x in twf.predictive_tick(
                *[torch.from_numpy(c) for c in cols],
                *torch.tensor(scalars, dtype=torch.float32).unbind())]
            for i in (0, 2, 3, 4, 5):     # level, idle, hist, desired, ttl
                assert got[i].tobytes() == want[i].tobytes(), (k, i)
            err = cols[0] - (cols[1] + cols[2])
            scale = np.maximum(np.abs(cols[2]), np.abs(ab * err))
            diff = np.abs(got[1].astype(np.float64) - want[1])
            assert (diff <= TREND_ULPS * np.spacing(scale)).all(), k
            checked += 1
        pol.tick(counts, bool(counts.any()))
    assert checked > 0


def test_gap_bucket_exact_at_powers_of_two():
    idle = np.array([0.0] + [2.0 ** k for k in range(16)]
                    + [2.0 ** k - 1 for k in range(2, 16)]
                    + [3.0, 5.0, 1000.0, 4095.0, 4097.0, 1e7])
    want = np.clip(np.floor(np.log2(np.maximum(idle, 1.0))), 0, 11)
    got = twf.gap_bucket(torch.tensor(idle, dtype=torch.float32), 12)
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.astype(int).tolist()


def test_auto_switches_on_rows(monkeypatch):
    bursts, exec_s = seeded_stream(3, 9, 40)
    monkeypatch.setattr(forecast, "TORCH_FORECAST_MIN", 10)
    forecast.set_forecast_backend("auto")
    pol = PredictivePolicy()
    trajectory(pol, bursts, exec_s)
    assert pol.torch_ticks == 0                      # 9 rows < 10
    monkeypatch.setattr(forecast, "TORCH_FORECAST_MIN", 9)
    pol = PredictivePolicy()
    trajectory(pol, bursts, exec_s)
    assert pol.torch_ticks == int(bursts.any(axis=1).sum())


def test_forecast_settings_restore_and_reject_unknown():
    with forecast.forecast_settings("torch", "cpu"):
        assert forecast.get_forecast_backend() == "torch"
        assert forecast.get_forecast_device() == "cpu"
    assert forecast.get_forecast_backend() == "auto"
    with pytest.raises(ValueError, match="unknown forecast backend"):
        forecast.set_forecast_backend("jax")
    pol = PredictivePolicy(backend="jax")
    pol.resize(2)
    with pytest.raises(ValueError, match="unknown forecast backend"):
        pol.tick(np.array([1.0, 0.0]), True)


def test_torch_tick_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    forecast.set_forecast_device(None)           # the default: the card
    pol = PredictivePolicy(backend="torch")
    pol.resize(3)
    with pytest.raises(devmod.NoCudaDevice, match="CUDA card"):
        pol.tick(np.array([1.0, 0.0, 2.0]), True)
    assert pol.torch_ticks == 0


# ---------------------------------------------------------- controller ---

def _scenario(pkg, pol, **kw):
    S, W = (JScenario, JWorkload) if pkg == "repro" else (TScenario,
                                                          TWorkload)
    base = dict(
        name="test/autoscale", platforms=("cloud-cluster",),
        platform_override="cloud-cluster",
        workloads=(W("nodeinfo", arrival={"kind": "diurnal",
                                          "mean_rps": 5.0,
                                          "period_s": 60.0,
                                          "peak_frac": 0.9}),),
        duration_s=120.0, drain_s=20.0, keepalive_w_per_replica=2.0,
        autoscale=pol)
    base.update(kw)
    return S(**base)


POLICY_ARMS = {
    "ttl": {"policy": "ttl", "policy_kwargs": {"ttl_s": 60.0}},
    "scale_to_zero": {"policy": "scale_to_zero",
                      "policy_kwargs": {"idle_s": 2.0}},
    "concurrency": {"policy": "concurrency"},
    "predictive": {"policy": "predictive"},
}


@pytest.mark.parametrize("arm,forecaster", [
    (arm, "numpy") for arm in sorted(POLICY_ARMS)] + [
    ("predictive", "torch")])
def test_autoscale_scenario_equals_reference_bytes(arm, forecaster):
    """The reference forecasts on NumPy (one managed row is below its
    jitted threshold); the port on NumPy, then forced to torch."""
    want = jrun(_scenario("repro", POLICY_ARMS[arm])).report.to_json()
    tsched.set_score_backend("numpy")
    tsched.set_score_device("cpu")
    forecast.set_forecast_backend(forecaster)
    run = trun(_scenario("repro_torch", POLICY_ARMS[arm]), "cpu")
    assert run.report.to_json() == want
    ctl = run.control_plane.autoscaler
    assert json.loads(want)["totals"]["autoscale"]["ticks"] == ctl.ticks > 0
    assert (ctl.policy.torch_ticks > 0) == (forecaster == "torch")


def test_controller_state_equals_reference():
    jcp = jrun(_scenario("repro", POLICY_ARMS["scale_to_zero"]))[1]
    tsched.set_score_backend("numpy")
    tsched.set_score_device("cpu")
    tcp = trun(_scenario("repro_torch", POLICY_ARMS["scale_to_zero"]),
               "cpu").control_plane
    for attr in ("ticks", "prewarmed", "retired", "_rows"):
        assert getattr(tcp.autoscaler, attr) == getattr(jcp.autoscaler, attr)
    jp, tp = jcp.platforms["cloud-cluster"], tcp.platforms["cloud-cluster"]
    assert tp.managed_keepalive is jp.managed_keepalive is True
    assert tp._mem_replicas_mb == jp._mem_replicas_mb
    assert tp.idle_warm_total() == jp.idle_warm_total()


def test_attach_autoscaler_adopts_a_late_platform():
    nodeinfo = TSpec(name="nodeinfo", flops=1e6, memory_mb=128)
    cp = TPlane()
    cp.create_platform(tprof.PAPER_PLATFORMS["cloud-cluster"])
    cp.deploy(TDeploy("t", [nodeinfo], ["cloud-cluster"]))
    ctl = cp.attach_autoscaler(policy="ttl", start=False)
    assert isinstance(ctl, WarmPoolController) and cp.autoscaler is ctl
    late = cp.create_platform(tprof.PAPER_PLATFORMS["edge-cluster"])
    assert late.managed_keepalive is True
    assert late.autoscale_counts is not None
    assert "edge-cluster" in ctl._by_name


def test_controller_ticks_equal_reference():
    """The bench_autoscale drive (25 managed rows, an arrival burst every
    8th tick) through both controllers: the same pool moves."""
    spec = {"nodeinfo": (1e6, 128), "heavy": (1e9, 512)}
    planes = []
    for Plane, prof, Deploy, Spec, make in (
            (JPlane, jprof, JDeploy, JSpec, jmake),
            (TPlane, tprof, TDeploy, TSpec, make_policy)):
        cp = Plane()
        for name in ("cloud-cluster", "edge-cluster"):
            cp.create_platform(prof.PAPER_PLATFORMS[name])
        cp.deploy(Deploy("t", [Spec(name=n, flops=f, memory_mb=m)
                               for n, (f, m) in spec.items()],
                         list(cp.platforms)))
        ctl = cp.attach_autoscaler(policy="predictive", start=False)
        p0 = next(iter(cp.platforms.values()))
        for i in range(400):
            cp.clock._t += 1.0
            if i % 8 == 0:
                c = p0.autoscale_counts
                c["nodeinfo"] = c.get("nodeinfo", 0) + 5
            ctl.tick()
        planes.append((ctl.ticks, ctl.prewarmed, ctl.retired,
                       ctl.policy._desired.tobytes(),
                       ctl.policy._ttl_s_out.tobytes()))
    assert planes[0] == planes[1]
    assert planes[1][0] == 400 and planes[1][2] > 0
