"""Chunked streaming replay in the port against the reference: the same
seeded minute-count trace through both packages' ``stream_replay`` gives
equal totals and the same folded perf-model state, and ``chunk_batch``
gives the same columns. Both fold in float64 NumPy (the torch decision
backend computes in float32 and must pick the same platforms), so every
number is compared exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.fdn_common import (IMAGE_KEY, JSON_KEY, REMOTE_STORE,  # noqa: E402,E501
                                   build_fdn)
from repro.core.scheduler import SLOCompositePolicy as JComposite  # noqa: E402,E501
from repro.inspector.streaming import chunk_batch as jchunk  # noqa: E402
from repro.inspector.streaming import stream_replay as jreplay  # noqa: E402
from repro.inspector.traces import synthetic_azure_counts as jcounts  # noqa: E402,E501
from repro_torch.core import FDNControlPlane as TPlane  # noqa: E402
from repro_torch.core import functions as tfunctions  # noqa: E402
from repro_torch.core import profiles as tprofiles  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core.loadgen import attach_completion_hooks  # noqa: E402
from repro_torch.core.types import DeploymentSpec  # noqa: E402
from repro_torch.inspector.streaming import chunk_batch as tchunk  # noqa: E402,E501
from repro_torch.inspector.streaming import stream_replay as treplay  # noqa: E402,E501
from repro_torch.inspector.traces import synthetic_azure_counts as tcounts  # noqa: E402,E501

FNS = ("nodeinfo", "primes-python", "JSON-loads")


@pytest.fixture(autouse=True)
def _score_state():
    yield
    tsched.set_score_backend("auto")
    tsched.set_score_device(None)


def tbuild():
    """``benchmarks.fdn_common.build_fdn(analytic=True)`` in the port, on
    the CPU."""
    cp = TPlane()
    names = list(tprofiles.PAPER_PLATFORMS)
    for name in names:
        cp.create_platform(tprofiles.PAPER_PLATFORMS[name])
    fns = {k: f.replace(real_fn=None) for k, f in tfunctions.paper_functions(
        IMAGE_KEY, JSON_KEY, device="cpu").items()}
    tfunctions.seed_object_stores(cp.placement, IMAGE_KEY, JSON_KEY,
                                  location="cloud-cluster", device="cpu")
    cp.placement.add_store(REMOTE_STORE)
    tfunctions.seed_object_stores(cp.placement, IMAGE_KEY, JSON_KEY,
                                  location=REMOTE_STORE, device="cpu")
    for name in names:
        cp.placement.set_bandwidth(name, REMOTE_STORE, 2e6)
    cp.deploy(DeploymentSpec("fdninspector", list(fns.values()), names))
    attach_completion_hooks(cp)
    return cp, fns


class _JStateful(JComposite):
    def fn_decisions(self, fns, snap, n=None):
        return None                       # force the representative path


class _TStateful(tsched.SLOCompositePolicy):
    def fn_decisions(self, fns, snap):
        return None


def replay_both(chunk_minutes, seed, stateful=False, backend="numpy",
                minutes=30, mean_rpm=40.0):
    jcp, _gw, jfns = build_fdn(analytic=True)
    tcp, tfns = tbuild()
    for cp in (jcp, tcp):
        cp.kb.log_decisions = False
    if stateful:
        jcp.policy = _JStateful(jcp.perf, jcp.placement)
        tcp.policy = _TStateful(tcp.perf, tcp.placement)
    tsched.set_score_backend(backend)
    tsched.set_score_device("cpu")
    counts = jcounts(FNS, minutes=minutes, mean_rpm=mean_rpm, seed=seed)
    tc = tcounts(FNS, minutes=minutes, mean_rpm=mean_rpm, seed=seed)
    for name in FNS:
        np.testing.assert_array_equal(tc[name], counts[name])
    js = jreplay(jcp, jfns, counts, chunk_minutes=chunk_minutes, seed=seed)
    ts = treplay(tcp, tfns, tc, chunk_minutes=chunk_minutes, seed=seed)
    return (jcp, js), (tcp, ts)


def assert_same_state(got, want):
    """Every array of the perf model's columnar state (EWMA values and
    counts, both P² quantile states, cold-start EWMA), NaN equal to NaN."""
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, tuple):
            assert_same_state(g, w)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("chunk_minutes,seed,stateful,backend", [
    (7, 3, False, "numpy"), (1, 11, False, "numpy"),
    (30, 5, False, "numpy"), (7, 3, True, "numpy"),
    (7, 3, False, "torch"), (4, 9, False, "torch")])
def test_stream_replay_matches_reference(chunk_minutes, seed, stateful,
                                         backend):
    (jcp, js), (tcp, ts) = replay_both(chunk_minutes, seed, stateful,
                                       backend)
    assert ts.to_dict() == js.to_dict()
    assert ts.admitted > 0
    assert tcp.kb.decision_count == jcp.kb.decision_count
    if backend == "torch":
        assert tcp.policy.torch_decisions == ts.chunks
    assert_same_state(tcp.perf._state, jcp.perf._state)
    assert tcp.perf._frow == jcp.perf._frow
    for name in FNS:
        assert tcp.events.forecast_rate(name) == \
            jcp.events.forecast_rate(name)
    assert tcp.interactions.edges == jcp.interactions.edges


@pytest.mark.parametrize("seed", [0, 9])
def test_chunk_batch_matches_reference(seed):
    _jcp, _gw, jfns = build_fdn(analytic=True)
    _tcp, tfns = tbuild()
    sub = np.random.default_rng(seed).integers(0, 6, (3, 5))
    j = jchunk([jfns[n] for n in FNS], sub, 4, 60.0, seed)
    t = tchunk([tfns[n] for n in FNS], sub, 4, 60.0, seed)
    assert t.n == j.n == int(sub.sum())
    np.testing.assert_array_equal(t.fn_idx, j.fn_idx)
    np.testing.assert_array_equal(t.arrival_t, j.arrival_t)
    assert [s.name for s in t.specs] == [s.name for s in j.specs]
