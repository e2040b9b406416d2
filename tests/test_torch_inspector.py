"""The Inspector slice: the port's ``run_scenario`` gives the reference's
report byte for byte, and each golden in ``benchmarks/golden/`` still holds.

* the four registry scenarios whose goldens turn on no autoscale or
  observability layer: the port's canonical JSON equals the JAX package's
  from the same run, byte for byte, and ``diff_reports`` against the golden
  finds no drift. (The reference's own report of ``chains/etl-pipeline`` is
  not byte-equal to its golden: one ``transfer_s`` leaf differs in its last
  digits, inside ``diff_reports``' tolerance.)
* the torch decision backend on the CPU gives the numpy backend's bytes;
* small scenarios through every policy and runner option against the
  reference, byte for byte;
* the registry lists the reference's names, and the scenarios that need the
  autoscale or observability layers raise ``NotImplementedError`` naming
  their ROADMAP item instead of running without them.

Both packages report float64 NumPy numbers, so the comparison is exact."""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from benchmarks.scenario_diff import diff_reports  # noqa: E402
from repro.inspector import Scenario as JScenario  # noqa: E402
from repro.inspector import FaultEvent as JFault, Workload as JWorkload  # noqa: E402,E501
from repro.inspector import registry as jregistry  # noqa: E402
from repro.inspector import run_scenario as jrun  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.inspector import Scenario as TScenario  # noqa: E402
from repro_torch.inspector import FaultEvent as TFault, Workload as TWorkload  # noqa: E402,E501
from repro_torch.inspector import ScenarioReport  # noqa: E402
from repro_torch.inspector import registry as tregistry  # noqa: E402
from repro_torch.inspector import run_scenario_state  # noqa: E402
from repro_torch.kernels import policy_score as tps  # noqa: E402

GOLDEN = Path(__file__).resolve().parent.parent / "benchmarks" / "golden"
GOLDEN_SCENARIOS = ("smoke/tiny", "paper/fig10-weighted",
                    "qos/burst-storm-drr", "chains/etl-pipeline")
PAIR = ("hpc-node-cluster", "cloud-cluster")
POLICIES = ("perf_ranked", "utilization_aware", "round_robin", "weighted",
            "data_locality", "warm_aware", "energy_aware", "slo_composite")
_REPORTS = {}


@pytest.fixture(autouse=True)
def _score_state():
    yield
    tsched.set_score_backend("auto")
    tsched.set_score_device(None)
    tps.set_use_pallas(False)


def port_run(sc, backend="numpy"):
    tsched.set_score_backend(backend)
    tsched.set_score_device("cpu")
    run = run_scenario_state(sc, "cpu")
    return run.report.to_json(), run.control_plane.policy.torch_decisions


def reports(name):
    """(reference JSON, port JSON) of a registry scenario, run once."""
    if name not in _REPORTS:
        _REPORTS[name] = (jrun(jregistry.get(name)).to_json(),
                          port_run(tregistry.get(name))[0])
    return _REPORTS[name]


@pytest.mark.parametrize("name", GOLDEN_SCENARIOS)
def test_registry_scenario_equals_reference_bytes(name):
    want, got = reports(name)
    assert got == want
    ScenarioReport.validate(json.loads(got))


@pytest.mark.parametrize("name", GOLDEN_SCENARIOS)
def test_registry_scenario_matches_golden(name):
    golden = json.loads((GOLDEN / f"{name.replace('/', '_')}.json")
                        .read_text())
    _, got = reports(name)
    assert diff_reports(json.loads(got), golden) == []


@pytest.mark.parametrize("name", ("smoke/tiny", "chains/etl-pipeline"))
def test_torch_backend_gives_numpy_bytes(name):
    sc = tregistry.get(name)
    want, none = port_run(sc, "numpy")
    got, decisions = port_run(sc, "torch")
    assert none == 0 and decisions > 0
    assert got == want


def _tiny(pkg, **kw):
    S, W = (JScenario, JWorkload) if pkg == "repro" else (TScenario,
                                                          TWorkload)
    base = dict(
        name="test/tiny", platforms=PAIR,
        workloads=(W("nodeinfo", arrival={"kind": "poisson", "rps": 25.0}),
                   W("JSON-loads", mode="closed", vus=3, sleep_s=0.05),
                   W("primes-python",
                     arrival={"kind": "mmpp", "base_rps": 2.0,
                              "burst_rps": 20.0, "mean_quiet_s": 2.0,
                              "mean_burst_s": 1.0})),
        duration_s=8.0, drain_s=20.0)
    base.update(kw)
    return S(**base)


VARIANTS = {
    **{f"policy={p}": dict(policy=p) for p in POLICIES},
    "object-path": dict(columnar=False),
    "hedging": dict(enable_hedging=True, predictive_prewarm=True),
    "override": dict(platform_override="cloud-cluster"),
    "lb=round_robin": dict(lb_policy="round_robin"),
    "slo-bg-load": dict(slo_overrides={"nodeinfo": 0.5},
                        bg_cpu={"cloud-cluster": 0.9},
                        bg_mem={"hpc-node-cluster": 0.7}),
    "retain": dict(retain_objects=True, defer_metrics=False),
    "keepalive-watts": dict(keepalive_w_per_replica=2.0),
    "qos": dict(qos={"weights": [8, 3, 1],
                     "slo_multipliers": [0.5, 1.0, 4.0],
                     "shed_queue_depth": 20}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS) + ["fault"])
def test_small_scenario_equals_reference_bytes(variant):
    if variant == "fault":
        kw = {pkg: dict(faults=(F(2.0, "hpc-node-cluster", "fail"),
                                F(5.0, "hpc-node-cluster", "recover")))
              for pkg, F in (("repro", JFault), ("repro_torch", TFault))}
    else:
        kw = {pkg: VARIANTS[variant] for pkg in ("repro", "repro_torch")}
    want = jrun(_tiny("repro", **kw["repro"])).to_json()
    got, _ = port_run(_tiny("repro_torch", **kw["repro_torch"]))
    assert got == want


def test_registry_names_match_reference():
    assert tregistry.names() == jregistry.names()
    for name in ("qos/burst-storm-drr", "chains/split-vs-colocate-ab",
                 "autoscale/diurnal-predictive", "telemetry/hpc-outage"):
        assert tregistry.get(name).to_dict() == \
            jregistry.get(name).to_dict()


@pytest.mark.parametrize("name,item", [
    ("telemetry/smoke-quiet", 6), ("prov/smoke-tiny", 6),
    ("trace/hpc-outage", 6), ("autoscale/diurnal-ttl", 5),
    ("prov/etl-pipeline", 6)])
def test_unported_layer_scenarios_raise(name, item):
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md, Queue 1 item {item}\\)"):
        port_run(tregistry.get(name))
