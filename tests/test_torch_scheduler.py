"""The port's scheduler (``repro_torch.core.scheduler``) against the JAX
package's on the same seeded platform states and invocation mixes
(``tests/test_admission_fastpath.py``'s randomized scenarios): every policy,
the port's numpy backend against ``repro``'s numpy backend, and the port's
torch backend, with and without the kernel switch (on the CPU: K1's plain
version), against ``repro``'s jax backend. Both control planes are built
from the same seeded state; platform choices are compared name for name.

Widths: both numpy backends compute in float64, both jax/torch backends in
float32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import functions as jfunctions  # noqa: E402
from repro.core import profiles as jprofiles  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core.control_plane import FDNControlPlane as JPlane  # noqa: E402
from repro.core.loadgen import attach_completion_hooks as jhooks  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro_torch.core import functions as tfunctions  # noqa: E402
from repro_torch.core import profiles as tprofiles  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core.control_plane import FDNControlPlane as TPlane  # noqa: E402,E501
from repro_torch.core.loadgen import attach_completion_hooks as thooks  # noqa: E402,E501
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.device import NoCudaDevice  # noqa: E402
from repro_torch.kernels import policy_score as tps  # noqa: E402

SEED = 20260730
TRIALS = 4
N_INVS = 96

PACKAGES = {
    "repro": (JPlane, jprofiles, jfunctions, jtypes, jhooks, jsched),
    "repro_torch": (TPlane, tprofiles, tfunctions, ttypes, thooks, tsched),
}


def policy_factories(sched):
    return {
        "perf_ranked": lambda cp: sched.PerformanceRankedPolicy(cp.perf),
        "utilization": lambda cp: sched.UtilizationAwarePolicy(
            cp.perf, cpu_threshold=0.7),
        "round_robin": lambda cp: sched.RoundRobinCollaboration(),
        "weighted": lambda cp: sched.WeightedCollaboration(
            {"hpc-node-cluster": 5, "cloud-cluster": 1, "edge-cluster": 2}),
        "data_locality": lambda cp: sched.DataLocalityPolicy(cp.perf,
                                                             cp.placement),
        "warm_aware": lambda cp: sched.WarmAwarePolicy(cp.perf,
                                                       cp.placement),
        "energy": lambda cp: sched.EnergyAwarePolicy(cp.perf),
        "slo_composite": lambda cp: sched.SLOCompositePolicy(cp.perf,
                                                             cp.placement),
    }


@pytest.fixture(autouse=True)
def _score_state():
    tsched.set_score_device("cpu")
    yield
    jsched.set_score_backend("auto")
    tsched.set_score_backend("auto")
    tsched.set_score_device(None)
    tps.set_use_pallas(False)


@pytest.fixture(scope="module")
def specs():
    """Each package's paper functions, analytic (no real bodies)."""
    jf = {k: f.replace(real_fn=None)
          for k, f in jfunctions.paper_functions().items()}
    tf = {k: f.replace(real_fn=None)
          for k, f in tfunctions.paper_functions(device="cpu").items()}
    return {"repro": jf, "repro_torch": tf}


def scenario(pkg: str, fns, trial: int):
    """One trial of test_admission_fastpath's randomized scenario, built in
    ``pkg`` from rng ``(SEED, trial)``: a random platform subset, random
    background load, random observed executions, and a mixed invocation
    list (half of them with a random SLO)."""
    plane, profiles, functions, types, hooks, _ = PACKAGES[pkg]
    rng = np.random.default_rng([SEED, trial])
    all_names = list(profiles.PAPER_PLATFORMS)
    k = int(rng.integers(2, len(all_names) + 1))
    names = list(rng.choice(all_names, size=k, replace=False))
    cp = plane()
    for n in names:
        cp.create_platform(profiles.PAPER_PLATFORMS[n])
    kw = {} if pkg == "repro" else {"device": "cpu"}
    functions.seed_object_stores(cp.placement, location="cloud-cluster",
                                 **kw)
    cp.deploy(types.DeploymentSpec("t", list(fns.values()),
                                   list(cp.platforms)))
    hooks(cp)
    for p in cp.platforms.values():
        p.bg_cpu = float(rng.uniform(0, 1.2))
        p.bg_mem = float(rng.uniform(0, 0.8))
    for fn in fns.values():
        for pname in cp.platforms:
            for _ in range(int(rng.integers(0, 15))):
                inv = types.Invocation(fn, 0.0)
                inv.platform = pname
                inv.exec_time = float(rng.uniform(0.01, 8.0))
                inv.end_t = inv.exec_time
                cp.perf.observe(inv)
    mixed = list(fns.values())
    mixed = [s if rng.random() < 0.5 else
             s.replace(slo=types.SLO(p90_response_s=float(
                 rng.uniform(0.05, 10))))
             for s in mixed]
    invs = [mixed[int(rng.integers(0, len(mixed)))] for _ in range(N_INVS)]
    return cp, invs


def picks(pkg: str, cp, invs, pname: str):
    _, _, _, types, _, sched = PACKAGES[pkg]
    pol = policy_factories(sched)[pname](cp)        # fresh rotation state
    got = pol.choose_batch([types.Invocation(fn, 0.0) for fn in invs],
                           list(cp.platforms.values()))
    return [p.prof.name if p else None for p in got], pol


@pytest.mark.parametrize("pname", sorted(policy_factories(tsched)))
def test_port_picks_the_reference_platforms(pname, specs):
    for trial in range(TRIALS):
        jcp, jinvs = scenario("repro", specs["repro"], trial)
        tcp, tinvs = scenario("repro_torch", specs["repro_torch"], trial)
        assert list(jcp.platforms) == list(tcp.platforms)
        assert [f.name for f in jinvs] == [f.name for f in tinvs]
        jsched.set_score_backend("numpy")
        want_np, _ = picks("repro", jcp, jinvs, pname)
        jsched.set_score_backend("jax")
        want_jax, _ = picks("repro", jcp, jinvs, pname)
        assert want_np == want_jax

        tsched.set_score_backend("numpy")
        got_np, pol = picks("repro_torch", tcp, tinvs, pname)
        assert pol.torch_decisions == 0
        assert got_np == want_np, f"{pname} trial {trial}: numpy backends"
        tsched.set_score_backend("torch")
        for kernel in (False, True):
            tps.set_use_pallas(kernel)
            got, pol = picks("repro_torch", tcp, tinvs, pname)
            assert got == want_jax, \
                f"{pname} trial {trial}: torch (kernel={kernel}) vs jax"
            stateless = pname not in ("round_robin", "weighted")
            assert pol.torch_decisions == int(stateless)
    assert tps.fused_composite_decide_cuda.launches == 0


def test_auto_backend_switches_at_the_batch_threshold(specs):
    cp, invs = scenario("repro_torch", specs["repro_torch"], 0)
    pol = tsched.SLOCompositePolicy(cp.perf, cp.placement)
    plats = list(cp.platforms.values())
    tsched.set_score_backend("auto")
    # the threshold's number of distinct functions (by identity): copies
    # of the scenario's mix; a decision counts functions, not invocations
    mix = [invs[i % len(invs)].replace()
           for i in range(tsched.TORCH_DECIDE_MIN)]
    small = [ttypes.Invocation(fn, 0.0) for fn in mix[:-1]]
    small += [ttypes.Invocation(mix[0], 0.0)] * tsched.TORCH_DECIDE_MIN
    pol.choose_batch(small, plats)
    assert pol.torch_decisions == 0
    big = [ttypes.Invocation(fn, 0.0) for fn in mix]
    pol.choose_batch(big, plats)
    assert pol.torch_decisions == 1
    with pytest.raises(ValueError, match="unknown score backend"):
        tsched.set_score_backend("jax")


def test_torch_backend_wants_the_card_by_default(specs):
    """No silent degrade: with the score device left at its default (the
    card) a torch decision on a machine without one raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    cp, invs = scenario("repro_torch", specs["repro_torch"], 1)
    tsched.set_score_device(None)
    tsched.set_score_backend("torch")
    pol = tsched.SLOCompositePolicy(cp.perf, cp.placement)
    with pytest.raises(NoCudaDevice):
        pol.choose_batch([ttypes.Invocation(invs[0], 0.0)],
                         list(cp.platforms.values()))


def test_k1_on_the_card_takes_the_staged_route(specs, monkeypatch):
    """With the kernel switch on and the card as score device, the
    composite decision hands its eleven host arrays to K1's staged route
    and returns that route's numpy arrays as they are; the route itself
    runs on the card (tests/test_torch_cuda.py), so here it is a stand-in
    that runs the plain version."""
    cp, invs = scenario("repro_torch", specs["repro_torch"], 2)
    calls = []

    def staged(*args, device):
        calls.append((args, device))
        got = tps.fused_composite_decide(
            *[tps.as_tensor(a, "cpu") for a in args[:11]], args[11])
        return got[0].numpy(), got[1].numpy()

    monkeypatch.setattr(tps, "fused_composite_decide_staged", staged)
    monkeypatch.setattr(tsched, "resolve", lambda d: torch.device("cuda"))
    plats = list(cp.platforms.values())
    batch = [ttypes.Invocation(fn, 0.0) for fn in invs]
    tsched.set_score_backend("torch")
    tps.set_use_pallas(True)
    pol = tsched.SLOCompositePolicy(cp.perf, cp.placement)
    got = pol.choose_batch(batch, plats)
    assert len(calls) == 1 and pol.torch_decisions == 1
    args, device = calls[0]
    assert device == torch.device("cuda")
    assert all(isinstance(a, np.ndarray) for a in args[:11])
    assert args[11] == pol.energy_weight
    tsched.set_score_backend("numpy")
    want = pol.choose_batch(batch, plats)
    assert [p.prof.name if p else None for p in got] == \
        [p.prof.name if p else None for p in want]
