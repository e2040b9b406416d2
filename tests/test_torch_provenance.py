"""Decision provenance (the journal) and what-if replay of the port against
the JAX package's on the same seeded inputs.

* the three prov/* scenarios: the port's report equals the reference's
  byte for byte, ``decision_provenance`` included; the journal's columns
  equal the reference journal's; the same-policy replay oracle holds;
* ``prov/smoke-tiny`` under the torch decision backend (on the CPU here;
  K1 on the card in chip_smoke.py): the journal records the torch
  backend's choices, the report equals numpy's bytes and the oracle holds;
* every stateless policy driven directly journals the reference's rows and
  replays them; stateful rotation policies journal nothing;
* what-if sections under every stateless policy, the SLO-scale sweep and a
  save / load round trip equal the reference's;
* the torch ``composite_explain`` agrees with the host cascade bit for bit
  on a dyadic grid (values exact in float32)."""
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.core import FDNControlPlane as JPlane  # noqa: E402
from repro.core import Invocation as JInv  # noqa: E402
from repro.core import functions as jfns  # noqa: E402
from repro.core import profiles as jprof  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.core.loadgen import attach_completion_hooks as jhooks  # noqa: E402,E501
from repro.core.scheduler import POLICIES as JPOLICIES  # noqa: E402
from repro.core.types import DeploymentSpec as JDeploy  # noqa: E402
from repro.inspector import registry as jregistry  # noqa: E402
from repro.inspector import run_scenario_state as jrun  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import FDNControlPlane as TPlane  # noqa: E402
from repro_torch.core import Invocation as TInv  # noqa: E402
from repro_torch.core import functions as tfns  # noqa: E402
from repro_torch.core import profiles as tprof  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.core.loadgen import attach_completion_hooks as thooks  # noqa: E402,E501
from repro_torch.core.scheduler import POLICIES  # noqa: E402
from repro_torch.core.scheduler import SLOCompositePolicy  # noqa: E402
from repro_torch.core.types import DeploymentSpec as TDeploy  # noqa: E402
from repro_torch.inspector import ScenarioReport  # noqa: E402
from repro_torch.inspector import registry as tregistry  # noqa: E402
from repro_torch.inspector import run_scenario_state as trun  # noqa: E402
from repro_torch.kernels import policy_score as tps  # noqa: E402
from repro_torch.obs.provenance import FEATURE_COLS, KILL_PAD  # noqa: E402

PROV = ("prov/smoke-tiny", "prov/etl-pipeline", "prov/burst-storm-drr")
STATELESS = {
    "perf_ranked": lambda P, cp: P["perf_ranked"](cp.perf),
    "utilization_aware": lambda P, cp: P["utilization_aware"](cp.perf),
    "data_locality": lambda P, cp: P["data_locality"](cp.perf,
                                                      cp.placement),
    "warm_aware": lambda P, cp: P["warm_aware"](cp.perf, cp.placement),
    "energy_aware": lambda P, cp: P["energy_aware"](cp.perf),
    "slo_composite": lambda P, cp: P["slo_composite"](cp.perf, cp.placement),
}
_RUNS = {}


@pytest.fixture(autouse=True)
def _score_state():
    yield
    tsched.set_score_backend("auto")
    tsched.set_score_device(None)


def prov(name):
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


def assert_same_journal(j, t):
    assert t.n == j.n > 0
    assert (t.policy_name, t.params, t.fn_names, t.pset_names) == \
        (j.policy_name, j.params, j.fn_names, j.pset_names)
    a, b = j.columns(), t.columns()
    assert sorted(a) == sorted(b)
    for k in a:
        assert b[k].dtype == a[k].dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


# ---------------------------------------------------------------------------
# the prov/* scenarios
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PROV)
def test_prov_report_equals_reference_bytes(name):
    want, got = prov(name)
    assert got.report.to_json() == want.report.to_json()
    dp = got.report.decision_provenance
    assert dp["decisions"] == got.control_plane.journal.n > 0
    ScenarioReport.validate(json.loads(got.report.to_json()))


@pytest.mark.parametrize("name", PROV)
def test_prov_journal_equals_reference(name):
    want, got = prov(name)
    assert_same_journal(want.control_plane.journal,
                        got.control_plane.journal)


@pytest.mark.parametrize("name", PROV)
def test_replay_oracle(name):
    journal = prov(name)[1].control_plane.journal
    assert obs.replay_matches(journal)
    assert obs.replay(journal).matches(journal)


def test_journal_columns_are_consistent():
    j = prov("prov/smoke-tiny")[1].control_plane.journal
    jc = j.columns()
    n, pmax = j.n, jc["kill"].shape[1]
    assert all(jc[k].shape == (n, pmax) for k in FEATURE_COLS)
    width = np.array([len(j.pset_names[int(p)]) for p in jc["pset"]])
    assert ((jc["choice"] >= -1) & (jc["choice"] < width)).all()
    pad = np.arange(pmax)[None, :] >= width[:, None]
    assert (jc["kill"][pad] == KILL_PAD).all()
    assert not jc["alive"][pad].any()
    ok = jc["choice"] >= 0
    assert (jc["kill"][np.nonzero(ok)[0], jc["choice"][ok]] == 0).all()


def test_decision_ids_join_to_the_chosen_platform():
    _report, cp, sink = prov("prov/smoke-tiny")[1]
    cols = sink.completion_columns()
    d = np.asarray(cols["decision"])
    assert (d >= 0).any()
    pid_to_name = {v: k for k, v in cols["platform_ids"].items()}
    for i in np.nonzero(d >= 0)[0]:
        assert pid_to_name[int(cols["platform"][i])] == \
            cp.journal.platform_of(int(d[i]))


def test_torch_backend_journal_gives_numpy_bytes():
    """The journal records whichever backend decided: under torch the
    report (decision_provenance included) is numpy's and the oracle, which
    re-scores on the host cascade, holds."""
    want, numpy_run = prov("prov/smoke-tiny")
    tsched.set_score_backend("torch")
    tsched.set_score_device("cpu")
    ttypes._inv_counter = itertools.count()
    run = trun(tregistry.get("prov/smoke-tiny"), "cpu")
    assert run.control_plane.policy.torch_decisions > 0
    assert run.report.to_json() == want.report.to_json()
    assert_same_journal(numpy_run.control_plane.journal,
                        run.control_plane.journal)
    assert obs.replay_matches(run.control_plane.journal)


# ---------------------------------------------------------------------------
# policies driven directly
# ---------------------------------------------------------------------------

def _build(pkg):
    Plane, prof, fmod, Deploy, hooks = (
        (JPlane, jprof, jfns, JDeploy, jhooks) if pkg == "repro" else
        (TPlane, tprof, tfns, TDeploy, thooks))
    cp = Plane()
    names = ("cloud-cluster", "edge-cluster")
    for n in names:
        cp.create_platform(prof.PAPER_PLATFORMS[n])
    kw = {} if pkg == "repro" else {"device": "cpu"}
    fns = {k: f.replace(real_fn=None)
           for k, f in fmod.paper_functions(**kw).items()}
    fmod.seed_object_stores(cp.placement, location=names[0], **kw)
    cp.deploy(Deploy("t", list(fns.values()), list(cp.platforms)))
    hooks(cp)
    return cp, fns


def _drive(pkg, cp, fns, rounds=5):
    Inv = JInv if pkg == "repro" else TInv
    picks = [fns["nodeinfo"], fns["image-processing"], fns["JSON-loads"]]
    for r in range(rounds):
        cp.submit_batch([Inv(f, float(r))
                         for f in picks[:1 + r % 3] for _ in range(4)])


def journaled(policy_name, rounds=5):
    """(reference journal, port journal) of one stateless policy driven
    through the same bursts."""
    out = []
    tsched.set_score_backend("numpy")
    for pkg, P, mod in (("repro", JPOLICIES, jobs),
                        ("repro_torch", POLICIES, obs)):
        cp, fns = _build(pkg)
        cp.policy = STATELESS[policy_name](P, cp)
        journal = cp.attach_provenance(mod.DecisionJournal())
        _drive(pkg, cp, fns, rounds)
        out.append(journal)
    return out


def test_stateless_builders_cover_the_registry():
    assert {n for n, c in POLICIES.items() if c.cascade is not None} == \
        set(STATELESS)


@pytest.mark.parametrize("policy_name", sorted(STATELESS))
def test_every_stateless_policy_journals_the_reference_rows(policy_name):
    j, t = journaled(policy_name)
    assert t.policy_name == policy_name
    assert_same_journal(j, t)
    assert obs.replay_matches(t)


@pytest.mark.parametrize("policy_name", ["round_robin", "weighted"])
def test_stateful_policies_never_journal(policy_name):
    cp, fns = _build("repro_torch")
    cp.policy = (POLICIES["round_robin"]() if policy_name == "round_robin"
                 else POLICIES["weighted"]({"cloud-cluster": 2,
                                            "edge-cluster": 1}))
    journal = cp.attach_provenance(obs.DecisionJournal())
    _drive("repro_torch", cp, fns, rounds=2)
    assert journal.n == 0
    with pytest.raises(ValueError, match="stateful"):
        obs.replay(journal)


# ---------------------------------------------------------------------------
# what-if, persistence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy_name", sorted(STATELESS))
def test_whatif_section_equals_reference(policy_name):
    want, got = prov("prov/smoke-tiny")
    j, t = want.control_plane.journal, got.control_plane.journal
    sec = obs.whatif_section(t, obs.replay(t),
                             obs.replay(t, obs.WhatIfConfig(policy_name)))
    ref = jobs.whatif_section(j, jobs.replay(j),
                              jobs.replay(j, jobs.WhatIfConfig(policy_name)))
    assert json.dumps(sec, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert sec["decisions"] == t.n


def test_whatif_parse_equals_reference():
    text = "policy=slo_composite,energy_weight=0.5,slo_scale=2.0"
    cfg = obs.WhatIfConfig.parse(text)
    ref = jobs.WhatIfConfig.parse(text)
    assert (cfg.policy, cfg.params, cfg.slo_scale) == \
        (ref.policy, ref.params, ref.slo_scale) == \
        ("slo_composite", {"energy_weight": 0.5}, 2.0)
    with pytest.raises(ValueError):
        obs.WhatIfConfig.parse("slo_scale=2.0")


def test_slo_scale_sweep_equals_reference():
    want, got = prov("prov/smoke-tiny")
    j, t = want.control_plane.journal, got.control_plane.journal
    routed = []
    for scale in (0.25, 1.0, 4.0):
        r = obs.replay(t, obs.WhatIfConfig(t.policy_name, slo_scale=scale))
        ref = jobs.replay(j, jobs.WhatIfConfig(j.policy_name,
                                               slo_scale=scale))
        assert r.choice.tobytes() == ref.choice.tobytes()
        assert r.ok.tobytes() == ref.ok.tobytes()
        routed.append(int((r.choice >= 0).sum()))
    assert routed[0] <= routed[1] <= routed[2]


def test_save_load_roundtrip(tmp_path):
    j = prov("prov/smoke-tiny")[1].control_plane.journal
    path = str(tmp_path / "journal.npz")
    j.save(path)
    j2 = obs.load_journal(path)
    assert (j2.n, j2.policy_name, j2.fn_names, j2.pset_names) == \
        (j.n, j.policy_name, j.fn_names, j.pset_names)
    assert j2.params == {k: float(v) for k, v in j.params.items()}
    a, b = j.columns(), j2.columns()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert obs.replay_matches(j2)
    # the reference loads the port's file and replays it the same way
    jj = jobs.load_journal(path)
    assert jobs.replay(jj).choice.tobytes() == \
        obs.replay(j2).choice.tobytes()


# ---------------------------------------------------------------------------
# torch explain vs the host cascade (dyadic grid: exact in float32)
# ---------------------------------------------------------------------------

_PARAMS = {"cpu_threshold": 0.75, "mem_threshold": 0.875,
           "energy_weight": 0.125}


def _dyadic_case(F, P, seed):
    rng = np.random.default_rng(seed)

    def grid(shape, span=256):
        return rng.integers(0, span, shape).astype(np.float64) / 64.0

    return {"exec_s": grid((F, P)), "data_s": grid((F, P)),
            "p90_s": grid((F, P)), "energy_j": grid((F, P)),
            "alive": rng.random((F, P)) < 0.85,
            "cpu_util": grid(P, 96), "mem_util": grid(P, 96),
            "slo_s": grid(F)}


def test_torch_explain_matches_host_cascade_on_a_seeded_sweep():
    rng = np.random.default_rng(7)
    shapes = [(1, 1, 0)] + [(int(rng.integers(1, 7)), int(rng.integers(1, 6)),
                             int(rng.integers(0, 2 ** 32)))
                            for _ in range(100)]
    for F, P, seed in shapes:
        feats = _dyadic_case(F, P, seed)
        cost, kill = SLOCompositePolicy.cascade(feats, _PARAMS)
        masked = np.where((kill == 0) & np.isfinite(cost), cost, np.inf)
        h_choice = np.argmin(masked, axis=1)
        h_ok = np.isfinite(masked).any(axis=1)
        unloaded = (feats["cpu_util"] < _PARAMS["cpu_threshold"]) & \
            (feats["mem_util"] < _PARAMS["mem_threshold"])
        out = tps.composite_explain(
            *(tps.as_tensor(feats[k], "cpu") for k in (
                "exec_s", "data_s", "p90_s", "energy_j", "alive")),
            tps.as_tensor(unloaded, "cpu"), tps.as_tensor(feats["slo_s"],
                                                          "cpu"),
            _PARAMS["energy_weight"])
        choice, ok, t_kill = (o.numpy() for o in out[:3])
        np.testing.assert_array_equal(ok, h_ok)
        np.testing.assert_array_equal(t_kill, kill)
        np.testing.assert_array_equal(out[5].numpy().astype(np.float64),
                                      cost)
        np.testing.assert_array_equal(choice[h_ok], h_choice[h_ok])
