"""The chains slice: both packages' data-gravity planner and chain executor,
on the same seeded platform states, give the same plans and the same
per-instance results.

Every template of ``chains/catalog`` is planned under every mode of
``PLAN_MODES`` over the five paper platforms, each with seeded background
load, seeded observed executions of every function and seeded
inter-platform bandwidths; then a few instances of the plan run through
``cp.chain_executor`` in both packages. Both packages plan and simulate in
float64 NumPy, so every float is compared exactly: ``ChainPlan.to_dict()``,
``stage_cost_s``, the planner's cost matrices and each instance's status,
latency, bytes moved, transfer seconds and stages done."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.chains import PLAN_MODES, catalog as jcatalog  # noqa: E402
from repro_torch.chains import ChainExecutor as TExecutor  # noqa: E402
from repro_torch.chains import catalog as tcatalog  # noqa: E402
from repro_torch.core import FDNControlPlane as TPlane  # noqa: E402

TEMPLATES = jcatalog.names()
SEEDS = (3, 11)


def _mods(pkg):
    return {m: importlib.import_module(f"{pkg}.{m}") for m in (
        "chains", "core", "core.functions", "core.profiles", "core.types",
        "core.loadgen", "core.scheduler")}


def harness(pkg, template, seed, device_kw):
    """The five paper platforms with seeded background load, observed
    executions and bandwidths; the paper functions (analytic) and the
    template's stage functions deployed; the template's inputs seeded."""
    m = _mods(pkg)
    rng = np.random.default_rng(seed)
    cp = m["core"].FDNControlPlane()
    names = list(m["core.profiles"].PAPER_PLATFORMS)
    for n in names:
        cp.create_platform(m["core.profiles"].PAPER_PLATFORMS[n])
    fns = {k: f.replace(real_fn=None) for k, f in
           m["core.functions"].paper_functions(**device_kw).items()}
    tmpl = m["chains"].catalog.get(template)
    fns.update(tmpl.functions)
    m["core.functions"].seed_object_stores(
        cp.placement, location="cloud-cluster", **device_kw)
    for inp in tmpl.inputs:
        cp.placement.stores[inp.location or "cloud-cluster"].put(
            inp.key, inp.size_bytes)
    cp.deploy(m["core.types"].DeploymentSpec("chains", list(fns.values()),
                                             names))
    m["core.loadgen"].attach_completion_hooks(cp)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            cp.placement.set_bandwidth(a, b, float(rng.uniform(3e6, 2e9)))
    for p in cp.platforms.values():
        p.bg_cpu = float(rng.uniform(0, 1.2))
        p.bg_mem = float(rng.uniform(0, 0.8))
    for fn in fns.values():
        for pname in names:
            for _ in range(int(rng.integers(0, 6))):
                inv = m["core.types"].Invocation(fn, 0.0)
                inv.platform = pname
                inv.exec_time = float(rng.uniform(0.01, 8.0))
                inv.end_t = inv.exec_time
                cp.perf.observe(inv)
    return cp, fns, tmpl, m


def plan_and_run(pkg, template, mode, seed):
    device_kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    cp, fns, tmpl, m = harness(pkg, template, seed, device_kw)
    planner = m["chains"].DataGravityPlanner(cp.policy, cp.placement, fns)
    plats = list(cp.platforms.values())
    snap = m["core.scheduler"].as_snapshot(plats)
    costs = planner.cost_matrices(tmpl.chain, snap)
    plan = planner.plan(tmpl.chain, plats, mode=mode)
    ex = cp.chain_executor(fns, batch_window_s=0.05)
    insts = []
    for t in (0.0, 0.3, 0.31, 2.0):
        cp.clock.schedule(t, lambda: insts.append(
            ex.launch(tmpl.chain, plan, label=f"{template}@{mode}")))
    cp.clock.run_until(900.0)
    results = [(i.id, i.status, i.latency, i.bytes_moved, i.transfer_s,
                i.stages_done) for i in insts]
    return plan, costs, results, ex, cp


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", PLAN_MODES)
@pytest.mark.parametrize("template", TEMPLATES)
def test_plans_and_instances_match_reference(template, mode, seed):
    jplan, jcosts, jres, jex, jcp = plan_and_run("repro", template, mode,
                                                 seed)
    tplan, tcosts, tres, tex, tcp = plan_and_run("repro_torch", template,
                                                 mode, seed)
    assert tplan.to_dict() == jplan.to_dict()
    assert tplan.stage_cost_s == jplan.stage_cost_s
    for t, j in zip(tcosts, jcosts):
        np.testing.assert_array_equal(t, j)
    assert tres == jres
    assert all(r[1] == "done" for r in tres)
    assert (tex.launched, tex.completed, tex.failed) == (
        jex.launched, jex.completed, jex.failed)
    assert tex.records == jex.records
    assert (tcp.completed_count, tcp.rejected_count) == (
        jcp.completed_count, jcp.rejected_count)


@pytest.mark.parametrize("template", TEMPLATES)
def test_catalog_templates_match_reference(template):
    t, j = tcatalog.get(template), jcatalog.get(template)
    assert t.chain.topo_order() == j.chain.topo_order()
    assert t.chain.sinks() == j.chain.sinks()
    assert [vars(s) for s in t.chain.stages] == [
        vars(s) for s in j.chain.stages]
    assert [vars(e) for e in t.chain.edges] == [
        vars(e) for e in j.chain.edges]
    assert [vars(i) for i in t.inputs] == [vars(i) for i in j.inputs]
    assert sorted(t.functions) == sorted(j.functions)
    for name, spec in t.functions.items():
        ref = j.functions[name]
        assert (spec.flops, spec.read_bytes, spec.write_bytes,
                spec.memory_mb, spec.slo.p90_response_s) == (
            ref.flops, ref.read_bytes, ref.write_bytes, ref.memory_mb,
            ref.slo.p90_response_s)


def test_platform_failure_matches_reference():
    """The colocation home fails mid-chain: both packages redeliver the
    stages and finish the instances alike."""
    out = {}
    for pkg in ("repro", "repro_torch"):
        device_kw = {"device": "cpu"} if pkg == "repro_torch" else {}
        cp, fns, tmpl, m = harness(pkg, "ab-dual-source", 5, device_kw)
        planner = m["chains"].DataGravityPlanner(cp.policy, cp.placement,
                                                 fns)
        plan = planner.plan(tmpl.chain, list(cp.platforms.values()),
                            mode="colocate")
        ex = cp.chain_executor(fns)
        inst = ex.launch(tmpl.chain, plan)
        cp.platforms[plan.assignment["join"]].fail()
        cp.clock.run_until(900.0)
        out[pkg] = (inst.status, inst.latency, inst.bytes_moved,
                    inst.transfer_s, inst.stages_done,
                    cp.redeliverer.redelivered)
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][0] == "done" and out["repro_torch"][-1] > 0


def test_chain_executor_factory_returns_the_ports_executor():
    cp = TPlane()
    ex = cp.chain_executor({}, batch_window_s=0.05)
    assert isinstance(ex, TExecutor)
    assert type(ex).__module__ == "repro_torch.chains.executor"
    assert ex.cp is cp and ex.batch_window_s == 0.05
