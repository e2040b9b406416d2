"""The admission slice as a whole: the same seeded arrival streams through
both packages' ``Gateway.request_batch`` into a ``ColumnarResultSink``
give byte-identical sink columns and counts.

* the burst: ``examples/batch_scheduling.py``'s run (paper platforms and
  functions, ``nodeinfo``, Poisson arrivals over 600 s at seed 42, 50 ms
  windows) at 3,000 arrivals, against the port's
  ``launch/batch_scheduling.run`` on the CPU, under each backend pair:
  numpy/numpy (float64 both) and jax/torch (float32 both), the latter with
  the kernel switch off and on;
* mixed functions: the five paper functions in one Poisson stream with
  hedging on, submitted as objects and as columns (the columnar path hands
  hedged batches to the object path), and as columns under a QoS spec.

Invocation ids come from a process-wide counter in each package, so they
are compared relative to the run's first id."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FDNControlPlane as JPlane, Gateway as JGateway  # noqa: E402,E501
from repro.core import functions as jfunctions  # noqa: E402
from repro.core import profiles as jprofiles  # noqa: E402
from repro.core import loadgen as jloadgen  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core.qos import QosSpec as JQos  # noqa: E402
from repro.core.types import DeploymentSpec as JDeploy  # noqa: E402
from repro_torch.core import FDNControlPlane as TPlane, Gateway as TGateway  # noqa: E402,E501
from repro_torch.core import functions as tfunctions  # noqa: E402
from repro_torch.core import profiles as tprofiles  # noqa: E402
from repro_torch.core import loadgen as tloadgen  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core.qos import QosSpec as TQos  # noqa: E402
from repro_torch.core.types import DeploymentSpec as TDeploy  # noqa: E402
from repro_torch.kernels import policy_score as tps  # noqa: E402
from repro_torch.launch import batch_scheduling  # noqa: E402

ARRIVALS = 3000


@pytest.fixture(autouse=True)
def _score_state():
    yield
    jsched.set_score_backend("auto")
    tsched.set_score_backend("auto")
    tsched.set_score_device(None)
    tps.set_use_pallas(False)


def columns(sink):
    cols = sink.completion_columns()
    cols["inv_id"] = cols["inv_id"] - cols["inv_id"].min()
    cols["fn_specs"] = sorted(cols["fn_specs"])
    return cols


def assert_same_sinks(got, want):
    g, w = columns(got), columns(want)
    assert set(g) == set(w)
    for k in w:
        if isinstance(w[k], np.ndarray):
            assert g[k].dtype == w[k].dtype, k
            assert g[k].tobytes() == w[k].tobytes(), k
        else:
            assert g[k] == w[k], k
    assert (got.completed, got.rejected, got.submitted) == (
        want.completed, want.rejected, want.submitted)
    assert got.cold_start_count() == want.cold_start_count()
    assert got.p90_response() == want.p90_response()


def reference_burst(n_arrivals: int):
    """``examples/batch_scheduling.py``'s run, in the JAX package."""
    cp = JPlane()
    for prof in jprofiles.PAPER_PLATFORMS.values():
        cp.create_platform(prof)
    fns = {k: f.replace(real_fn=None)
           for k, f in jfunctions.paper_functions().items()}
    jfunctions.seed_object_stores(cp.placement, location="cloud-cluster")
    cp.deploy(JDeploy("burst", list(fns.values()), list(cp.platforms)))
    gw = JGateway(cp)
    sink = jloadgen.ColumnarResultSink(capacity=n_arrivals).install(cp)
    arrivals = jloadgen.poisson_arrivals(n_arrivals / 600.0, 600.0, seed=42)
    jloadgen.run_arrivals(cp.clock, gw.request_batch, fns["nodeinfo"],
                          arrivals, batch_window_s=0.05, sink=sink)
    return sink


@pytest.mark.parametrize("jax_backend,torch_backend,kernel", [
    ("numpy", "numpy", False), ("jax", "torch", False),
    ("jax", "torch", True)])
def test_burst_sinks_are_byte_identical(jax_backend, torch_backend, kernel):
    jsched.set_score_backend(jax_backend)
    want = reference_burst(ARRIVALS)
    out = batch_scheduling.run(ARRIVALS, torch_backend, kernel, "cpu")
    assert_same_sinks(out["sink"], want)
    assert out["completed"] + out["rejected"] == out["arrivals"]
    if torch_backend == "torch":
        # every admission window made one decision on the torch backend
        assert out["torch_decisions"] > 0.8 * ARRIVALS
    else:
        assert out["torch_decisions"] == 0
    assert out["k1_launches"] == 0            # the CPU runs the plain K1
    assert tsched.get_score_backend() == "auto"    # restored


def mixed_stream(pkg: str, hedging: bool, columnar: bool, qos: bool,
                 n: int = ARRIVALS):
    """The five paper functions in one seeded Poisson stream (60 s, 50 ms
    windows), through ``Gateway.request_batch`` of ``pkg``."""
    if pkg == "repro":
        plane, gateway, profiles, functions, loadgen, deploy, spec = (
            JPlane, JGateway, jprofiles, jfunctions, jloadgen, JDeploy,
            JQos)
        fkw = {}
    else:
        plane, gateway, profiles, functions, loadgen, deploy, spec = (
            TPlane, TGateway, tprofiles, tfunctions, tloadgen, TDeploy,
            TQos)
        fkw = {"device": "cpu"}
    cp = plane(enable_hedging=hedging)
    for prof in profiles.PAPER_PLATFORMS.values():
        cp.create_platform(prof)
    fns = [f.replace(real_fn=None)
           for f in functions.paper_functions(**fkw).values()]
    functions.seed_object_stores(cp.placement, location="cloud-cluster",
                                 **fkw)
    cp.deploy(deploy("mix", fns, list(cp.platforms)))
    if qos:
        cp.attach_qos(spec(shed_queue_depth=6.0, overload_action="degrade"))
    loadgen.attach_completion_hooks(cp)
    gw = gateway(cp)
    sink = loadgen.ColumnarResultSink(capacity=n).install(cp)
    rng = np.random.default_rng(7)
    times = loadgen.poisson_arrivals(n / 60.0, 60.0, seed=43)
    fn_idx = rng.integers(0, len(fns), times.size)
    loadgen.run_arrival_mix(cp.clock, gw.request_batch, fns, times, fn_idx,
                            batch_window_s=0.05, sink=sink,
                            columnar=columnar)
    return sink, cp


@pytest.mark.parametrize("hedging,columnar,qos", [
    (True, False, False), (True, True, False), (False, True, True)])
def test_mixed_stream_sinks_are_byte_identical(hedging, columnar, qos):
    jsched.set_score_backend("jax")
    want, jcp = mixed_stream("repro", hedging, columnar, qos)
    tsched.set_score_backend("torch")
    tsched.set_score_device("cpu")
    got, tcp = mixed_stream("repro_torch", hedging, columnar, qos)
    assert_same_sinks(got, want)
    assert tcp.policy.torch_decisions > 0
    assert (tcp.completed_count, tcp.rejected_count) == (
        jcp.completed_count, jcp.rejected_count)
    hedge = ("hedges_sent", "hedges_won", "group_timers_armed",
             "group_timers_cancelled")
    assert [getattr(tcp.hedge, k) for k in hedge] == [
        getattr(jcp.hedge, k) for k in hedge]
    if hedging:
        assert tcp.hedge.group_timers_armed > 0


def test_attach_points_give_the_ports_layers():
    from repro_torch.autoscale import WarmPoolController
    from repro_torch.chains.executor import ChainExecutor
    from repro_torch.obs import DecisionJournal, FlightRecorder
    from repro_torch.obs.telemetry import TelemetryConfig, TelemetryEngine
    cp = TPlane()
    assert cp.recorder is None and cp.journal is None
    assert cp.telemetry is None and cp.autoscaler is None
    ctl = cp.attach_autoscaler(policy="predictive", start=False)
    assert isinstance(ctl, WarmPoolController) and cp.autoscaler is ctl
    rec = cp.attach_recorder(FlightRecorder())
    assert isinstance(rec, FlightRecorder) and cp.recorder is rec
    assert ctl.recorder is rec
    journal = cp.attach_provenance(DecisionJournal())
    assert isinstance(journal, DecisionJournal) and cp.journal is journal
    eng = cp.attach_telemetry(TelemetryEngine(TelemetryConfig()))
    assert isinstance(eng, TelemetryEngine) and cp.telemetry is eng
    assert cp.metrics.telemetry is eng
    assert isinstance(cp.chain_executor({}), ChainExecutor)
