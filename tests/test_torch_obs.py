"""The flight recorder (recorder, analysis, export) of the port against the
JAX package's on the same seeded scenarios.

* traced smoke/tiny, chains/etl-pipeline (20 s) and
  autoscale/burst-predictive (60 s): the report, the recorder's span
  columns, the decomposition and the Chrome trace equal the reference's,
  byte for byte, and every completion reconciles bitwise against the sink
  (the reference's load-bearing invariant, held on the port);
* ``trace/hpc-outage``'s ``latency_breakdown`` equals the reference's;
* tracing perturbs nothing, head-based sampling is deterministic, and the
  span-buffer, hedge-span, reject-span and alert-annotation units match
  the reference's.

Invocation ids come from a process-global counter in each package; every
run resets both, so each sees the id stream a fresh process would."""
import itertools
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.inspector import registry as jregistry  # noqa: E402
from repro.inspector import run_scenario_state as jrun  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import FDNControlPlane, Gateway  # noqa: E402
from repro_torch.core import functions as fn_mod  # noqa: E402
from repro_torch.core import profiles  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.core.types import DeploymentSpec, Invocation  # noqa: E402
from repro_torch.inspector import registry as tregistry  # noqa: E402
from repro_torch.inspector import run_scenario_state as trun  # noqa: E402

TRACED = {
    "smoke/tiny": {},
    "chains/etl-pipeline": {"duration_s": 20.0},
    "autoscale/burst-predictive": {"duration_s": 60.0},
}
_RUNS = {}


@pytest.fixture(autouse=True)
def _score_state():
    yield
    tsched.set_score_backend("auto")
    tsched.set_score_device(None)


def run_pair(name, **kw):
    """(reference run, port run) of a registry scenario with ``kw``
    replaced, each from a fresh invocation-id stream."""
    jtypes._inv_counter = itertools.count()
    want = jrun(jregistry.get(name).replace(**kw))
    ttypes._inv_counter = itertools.count()
    tsched.set_score_backend("numpy")
    tsched.set_score_device("cpu")
    got = trun(tregistry.get(name).replace(**kw), "cpu")
    return want, got


def traced(name):
    if name not in _RUNS:
        _RUNS[name] = run_pair(name, trace=True, **TRACED[name])
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(TRACED))
def test_traced_report_equals_reference_bytes(name):
    want, got = traced(name)
    assert got.report.to_json() == want.report.to_json()
    assert got.report.latency_breakdown["enabled"] is True


@pytest.mark.parametrize("name", sorted(TRACED))
def test_span_columns_equal_reference(name):
    want, got = traced(name)
    a = want.control_plane.recorder.spans.columns()
    b = got.control_plane.recorder.spans.columns()
    assert sorted(a) == sorted(b)
    for key in a:
        assert b[key].dtype == a[key].dtype, key
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    assert got.control_plane.recorder.fn_names() == \
        want.control_plane.recorder.fn_names()


@pytest.mark.parametrize("name", sorted(TRACED))
def test_exact_reconciliation(name):
    _, run = traced(name)
    report, cp, sink = run
    lb = report.latency_breakdown
    completed = report.totals["completed"]
    assert completed > 0
    assert lb["traced_invocations"] == completed
    assert lb["matched_completions"] == completed
    assert lb["exact_reconciled"] == completed
    assert lb["max_reconcile_err_s"] == 0.0
    decomp = obs.decompose(cp.recorder)
    np.testing.assert_array_equal(decomp.segments.sum(axis=1),
                                  decomp.response)
    rc = obs.reconcile(decomp, sink.completion_columns())
    assert rc["exact"] == rc["matched"] == completed
    jd = jobs.decompose(traced(name)[0].control_plane.recorder)
    np.testing.assert_array_equal(decomp.segments, jd.segments)


@pytest.mark.parametrize("name", sorted(TRACED))
def test_chrome_trace_equals_reference_bytes(name, tmp_path):
    want, got = traced(name)
    jn = jobs.write_chrome_trace(want.control_plane.recorder,
                                 str(tmp_path / "j.json"))
    tn = obs.write_chrome_trace(got.control_plane.recorder,
                                str(tmp_path / "t.json"))
    assert tn == jn > 0
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


def test_chain_critical_path_equals_reference():
    want, got = traced("chains/etl-pipeline")
    cpaths = obs.chain_critical_paths(got.control_plane.recorder)
    assert cpaths["instances"] > 0
    assert cpaths == jobs.chain_critical_paths(want.control_plane.recorder)
    assert got.report.latency_breakdown["chain_critical_path"] == cpaths


def test_trace_hpc_outage_breakdown_equals_reference():
    want, got = run_pair("trace/hpc-outage")
    lb = got.report.latency_breakdown
    assert lb["enabled"] is True and lb["slo_attribution"]["violations"] > 0
    assert json.dumps(lb, sort_keys=True) == json.dumps(
        want.report.latency_breakdown, sort_keys=True)


def test_tracing_does_not_perturb_results():
    tsched.set_score_backend("numpy")
    tsched.set_score_device("cpu")
    sc = tregistry.get("smoke/tiny")
    plain = json.loads(trun(sc, "cpu").report.to_json())
    traced_rep = json.loads(trun(sc.replace(trace=True), "cpu")
                            .report.to_json())
    for rep in (plain, traced_rep):
        rep.pop("latency_breakdown", None)
        rep.pop("scenario", None)
    assert traced_rep == plain


def test_sampling_deterministic_and_equal_to_reference():
    def port(sample):
        ttypes._inv_counter = itertools.count()
        sc = tregistry.get("smoke/tiny").replace(trace=True,
                                                 trace_sample=sample)
        return trun(sc, "cpu").control_plane.recorder

    tsched.set_score_backend("numpy")
    tsched.set_score_device("cpu")
    rec_a, rec_b = port(0.25), port(0.25)
    jtypes._inv_counter = itertools.count()
    jrec = jrun(jregistry.get("smoke/tiny").replace(
        trace=True, trace_sample=0.25)).control_plane.recorder
    a, b, j = (r.spans.columns() for r in (rec_a, rec_b, jrec))
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(a[key], j[key])
    assert 0 < rec_a.traced_invocations() < port(1.0).traced_invocations()
    assert obs.decompose(rec_a).inv.size == rec_a.traced_invocations()


def test_hedge_span_unit_equals_reference():
    fn = types.SimpleNamespace(name="nodeinfo")
    orig = types.SimpleNamespace(id=7, fn=fn)
    dup = types.SimpleNamespace(id=9, fn=fn)
    cols = []
    for pkg in (jobs, obs):
        rec = pkg.FlightRecorder()
        rec.record_hedge(dup, orig, 3.25)
        cols.append(rec.spans.columns())
    assert cols[1]["kind"].tolist() == [obs.HEDGE]
    assert cols[1]["link"].tolist() == [7]
    for key in cols[0]:
        np.testing.assert_array_equal(cols[1][key], cols[0][key])


def test_span_buffer_growth_equals_reference():
    cols = []
    for pkg in (jobs, obs):
        buf = pkg.SpanBuffer(capacity=2)
        for i in range(5):
            buf.add(i, 0, float(i), float(i + 1), 0, 0, 1)
        buf.add_many(np.arange(100), 1, 0.0, 1.0, 0, 0, 1)
        assert buf.n == 105
        cols.append(buf.columns())
    assert cols[1]["inv"][5:].tolist() == list(range(100))
    for key in cols[0]:
        np.testing.assert_array_equal(cols[1][key], cols[0][key])


def test_gateway_unauthorized_records_reject():
    cp = FDNControlPlane()
    cp.create_platform(profiles.PAPER_PLATFORMS["cloud-cluster"])
    fns = {k: f.replace(real_fn=None)
           for k, f in fn_mod.paper_functions(device="cpu").items()}
    cp.deploy(DeploymentSpec("t", list(fns.values()), list(cp.platforms)))
    gw = Gateway(cp)
    cp.attach_recorder(obs.FlightRecorder())
    inv = Invocation(fn=fns["nodeinfo"], arrival_t=0.0)
    assert gw.request(inv, token="wrong") is False
    cols = cp.recorder.spans.columns()
    rejects = cols["kind"] == obs.REJECT
    assert rejects.sum() == 1
    assert cols["link"][rejects].tolist() == [1]


def test_attach_recorder_taps_hedges_once():
    cp = FDNControlPlane(enable_hedging=True)
    rec = obs.FlightRecorder()
    cp.attach_recorder(rec)
    cp.attach_recorder(rec)
    assert cp._hedge_tap is True
    assert len(cp.hedge.on_duplicate) == 1
    fn = types.SimpleNamespace(name="nodeinfo")
    cp.hedge.on_duplicate[0](types.SimpleNamespace(id=3, fn=fn),
                             types.SimpleNamespace(id=4, fn=fn))
    assert rec.spans.columns()["kind"].tolist() == [obs.HEDGE]


def test_alert_annotation_events_equal_reference():
    slo = [{"t": 12.0, "kind": "fire", "fn": "f", "rule": "fast_burn",
            "severity": "page", "burn_short": 9.1, "burn_long": 8.2}]
    health = [{"t": 30.0, "kind": "fire", "platform": "edge-cluster",
               "metric": "queue_depth", "z": 7.5},
              {"t": 31.0, "kind": "resolve", "platform": "never-seen",
               "metric": "watts", "z": 1.0}]
    pnames = ["hpc-node-cluster", "edge-cluster"]
    got = obs.alert_annotation_events(slo, health, pnames)
    assert got == jobs.alert_annotation_events(slo, health, pnames)
    assert [e["pid"] for e in got] == [0, 2, 0]


def test_chrome_trace_alert_annotations_equal_reference(tmp_path):
    want, got = run_pair("telemetry/hpc-outage", trace=True)
    alerts = got.report.alerts
    assert alerts["enabled"] and alerts["health"]["fires"] > 0
    n = obs.write_chrome_trace(got.control_plane.recorder,
                               str(tmp_path / "t.json"), alerts=alerts)
    jn = jobs.write_chrome_trace(want.control_plane.recorder,
                                 str(tmp_path / "j.json"),
                                 alerts=want.report.alerts)
    assert n == jn
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    notes = [e for e in events if e.get("cat") == "alert"]
    assert len(notes) == (len(alerts["slo"]["events"])
                          + len(alerts["health"]["events"])) > 0
