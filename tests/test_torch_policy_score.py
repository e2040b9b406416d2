"""The port's admission cascades (``repro_torch.kernels.policy_score``)
against the JAX package's on the same numpy-seeded inputs.

Widths compared, stated per test:

* torch twin vs ``jax.jit`` cascade: both float32 (the JAX package runs
  without x64); choices, masks and kill bits exact. XLA's CPU backend
  contracts the composite cost ``(exec + data) + w * energy`` into one FMA,
  while the port (plain versions and CUDA kernels alike) rounds the
  multiply and the add apart in the reference's association, so the
  explain bundle's cost may differ by one float32 rounding (rtol 2**-23)
  and its margin by that of two costs;
* K1/K2 plain versions (the wrappers on CPU tensors) vs the Pallas kernels
  in interpret mode: float32 both, exact, on finite cases;
* non-finite cases (NaN, +inf, -inf in feasible cells) vs the jit cascade
  (float32) and the NumPy host cascade (float64, on cases without
  float32 near-ties): choices and ok exact. The Pallas kernels differ there
  (ROADMAP.md, Queue 3) and are not compared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import policy_score as jps  # noqa: E402
from repro_torch.kernels import policy_score as tps  # noqa: E402
from policy_score_cases import (  # noqa: E402
    FUSED_ARGS, KINDS, PREBUILT_ARGS, make_case, prebuilt_columns)

SHAPES = [(1, 5), (5, 5), (10, 5), (37, 129)]
WEIGHTS = [0.0, 0.1, 0.5]


def tt(*arrays):
    return [tps.as_tensor(a, "cpu") for a in arrays]


def jx(*arrays):
    return [jnp.asarray(a) for a in arrays]


def same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _cases():
    for (f, p) in SHAPES:
        for kind in KINDS:
            yield f, p, kind


@pytest.mark.parametrize("f,p,kind", list(_cases()))
def test_cascades_match_jit(f, p, kind):
    """Every torch cascade against its jax.jit twin, float32 both: choice,
    ok, and the explain bundle's kill and runner exact; its cost and margin
    within XLA's FMA rounding (see the module docstring)."""
    for i, w in enumerate(WEIGHTS):
        c = make_case(1000 * f + 7 * p + i, f, p, kind, w)
        m = prebuilt_columns(c)
        ex, da, p90, en, al, un, slo = (m[k] for k in PREBUILT_ARGS)
        w = m["energy_weight"]
        warm = np.where(np.random.default_rng(i).random((f, p)) < 0.5,
                        0.0, 1.0)
        cold = np.linspace(1.5, 4.0, p)
        same(tps.perf_ranked_decide(*tt(ex, al)),
             jps.perf_ranked_decide(*jx(ex, al)))
        same(tps.utilization_decide(*tt(ex, al, un)),
             jps.utilization_decide(*jx(ex, al, un)))
        same(tps.locality_decide(*tt(ex, da, al)),
             jps.locality_decide(*jx(ex, da, al)))
        same(tps.warm_decide(*tt(ex, da, warm, cold, al)),
             jps.warm_decide(*jx(ex, da, warm, cold, al)))
        same(tps.energy_decide(*tt(en, p90, slo, al)),
             jps.energy_decide(*jx(en, p90, slo, al)))
        same(tps.composite_decide(*tt(ex, da, p90, en, al, un, slo), w),
             jps.composite_decide(*jx(ex, da, p90, en, al, un, slo), w))
        got = tps.composite_explain(*tt(ex, da, p90, en, al, un, slo), w)
        want = jps.composite_explain(*jx(ex, da, p90, en, al, un, slo), w)
        same(got[:4], want[:4])                # choice, ok, kill, runner
        cost, margin = (np.asarray(x) for x in want[4:][::-1])
        np.testing.assert_allclose(got[5].numpy(), cost, rtol=2 ** -23,
                                   atol=0)
        big = np.abs(cost[np.isfinite(cost)]).max(initial=0.0)
        np.testing.assert_allclose(got[4].numpy(), margin, rtol=0,
                                   atol=2 ** -22 * big)
        fused = [c[k] for k in FUSED_ARGS]
        same(tps.fused_composite_decide(*tt(*fused), w),
             jps.fused_composite_decide(*fused, w))


def _finite(c):
    return all(np.isfinite(c[k]).all() for k in ("ewma_v", "analytic_s"))


@pytest.mark.parametrize("f,p,kind", [c for c in _cases()
                                      if c[2] != "nonfinite"])
def test_kernel_plain_versions_match_pallas_interpret(f, p, kind):
    """K1's and K2's plain versions (the wrappers on CPU tensors) against
    the Pallas kernels in interpret mode, float32 both, exact, on finite
    inputs."""
    for i, w in enumerate(WEIGHTS):
        c = make_case(3000 * f + p + i, f, p, kind, w)
        w = c["energy_weight"]
        assert _finite(c)
        fused = [c[k] for k in FUSED_ARGS]
        got = tps.fused_composite_decide_pallas(*tt(*fused), w)
        same(got, jps.fused_composite_decide_pallas(*fused, w,
                                                    interpret=True))
        m = prebuilt_columns(c)
        cols = [m[k] for k in PREBUILT_ARGS]
        got2 = tps.composite_decide_pallas(*tt(*cols), w)
        same(got2, jps.composite_decide_pallas(*cols, w, interpret=True))
        # K1 and K2 decide alike on the columns K1 builds
        same(got2, [g.numpy() for g in got])
    assert tps.fused_composite_decide_cuda.launches == 0
    assert tps.composite_decide_cuda.launches == 0


def host_composite(c):
    """The NumPy host cascade (``SLOCompositePolicy.fn_cost_matrix`` +
    ``fn_decisions``) in float64."""
    with np.errstate(invalid="ignore"):      # 0 * inf, inf - inf
        exec_s = np.where(c["ewma_n"] >= 3, c["ewma_v"], c["analytic_s"])
        p90 = np.where(c["resp_n"] >= 10, c["resp_h2"], exec_s * 1.5)
        energy = (exec_s * c["nodes"][None]) * c["loaded_w"][None]
        alive = c["alive"]
        ok = alive & c["unloaded"][None]
        ok = np.where(ok.any(1, keepdims=True), ok, alive)
        feas = ok & (p90 <= c["slo_s"][:, None])
        feas = np.where(feas.any(1, keepdims=True), feas, ok)
        cost = (exec_s + c["data_s"]) + c["energy_weight"] * energy
        rows = np.where(feas, cost, np.inf)
    finite = np.isfinite(rows)
    return (np.argmin(np.where(finite, rows, np.inf), axis=1),
            finite.any(axis=1))


@pytest.mark.parametrize("f,p", SHAPES)
def test_nonfinite_costs_count_as_inf(f, p):
    """NaN, +inf and -inf in feasible cells: the plain versions of K1 and
    K2 follow ``_masked_argmin`` — the jit cascade (float32) and the NumPy
    host cascade (float64) — never the Pallas kernels' row_min compare. A
    row with no finite candidate returns choice 0 and ok False."""
    saw_dead_row = False
    for i, w in enumerate(WEIGHTS):
        c = make_case(5000 * f + p + i, f, p, "nonfinite", w)
        w = c["energy_weight"]
        fused = [c[k] for k in FUSED_ARGS]
        got = tps.fused_composite_decide_pallas(*tt(*fused), w)
        same(got, jps.fused_composite_decide(*fused, w))
        same(got, host_composite(c))
        m = prebuilt_columns(c)
        cols = [m[k] for k in PREBUILT_ARGS]
        same(tps.composite_decide_pallas(*tt(*cols), w), got)
        none = ~got[1].numpy()
        assert (got[0].numpy()[none] == 0).all()
        saw_dead_row |= bool(none.any())
    assert saw_dead_row or f == 1


def test_ties_go_to_the_lowest_platform():
    """An exact tie between columns 1 and 3 picks 1; costs one float32 ulp
    apart pick the lower cost, whichever column holds it."""
    f, p = 10, 5
    c = make_case(11, f, p, "tie")
    got = tps.fused_composite_decide_pallas(*tt(*[c[k] for k in
                                                  FUSED_ARGS]), 0.0)
    assert got[0].tolist() == [1] * f and got[1].all()
    c = make_case(12, f, p, "near_tie")
    got = tps.fused_composite_decide_pallas(*tt(*[c[k] for k in
                                                  FUSED_ARGS]), 0.0)
    assert got[0].tolist() == [1, 3] * (f // 2)
    same(got, jps.fused_composite_decide(*[c[k] for k in FUSED_ARGS], 0.0))


def test_boundary_widths():
    """Inputs cross into the decision at float32 / int32 / bool."""
    a, n, m = tt(np.ones((2, 3)), np.ones((2, 3), np.int64),
                 np.ones((2, 3), bool))
    assert (a.dtype, n.dtype, m.dtype) == (torch.float32, torch.int32,
                                           torch.bool)
    assert tps.weight_f32(0.1) == float(np.float32(0.1))


def test_cuda_wrappers_refuse_cpu_tensors():
    c = make_case(0, 2, 5, "random")
    args = tt(*[c[k] for k in FUSED_ARGS])
    with pytest.raises(ValueError, match="CUDA"):
        tps.fused_composite_decide_cuda(*args, 0.1)
    m = prebuilt_columns(c)
    cols = tt(*[m[k] for k in PREBUILT_ARGS])
    with pytest.raises(ValueError, match="CUDA"):
        tps.composite_decide_cuda(*cols)


# K1's staged route: the layout of its pinned block and the packing into
# it. The block itself (pinned host memory mapped into the card) and the
# launch on it are held on the card by tests/test_torch_cuda.py.

@pytest.mark.parametrize("f,p", SHAPES + [(4096, 1024), (3, 1), (1, 129)])
def test_staging_layout_is_aligned_and_disjoint(f, p):
    layout, nbytes = tps.staging_layout(f, p)
    assert [n for n, _, _ in tps.STAGED_ARRAYS] == list(layout)
    assert list(layout)[:tps.STAGED_INPUTS] == list(FUSED_ARGS)
    end = 0
    for name, (off, dtype, shape) in layout.items():
        assert off % tps.STAGE_ALIGN == 0 and off >= end
        end = off + int(np.prod(shape)) * dtype.itemsize
    assert end <= nbytes < end + tps.STAGE_ALIGN
    dims = {"fp": (f, p), "p": (p,), "f": (f,)}
    for name, dtype, kind in tps.STAGED_ARRAYS:
        assert layout[name][1:] == (np.dtype(dtype), dims[kind])


def test_staging_block_grows_to_the_next_power_of_two():
    assert tps.block_bytes(1) == tps.MIN_BLOCK
    sizes = [tps.staging_layout(f, p)[1] for f, p in
             [(1, 5), (10, 5), (37, 129), (4096, 1024)]]
    assert sizes == sorted(sizes)
    for n in sizes + [tps.MIN_BLOCK, tps.MIN_BLOCK + 1, 1 << 20]:
        got = tps.block_bytes(n)
        assert got >= n and got & (got - 1) == 0
        assert got == tps.MIN_BLOCK or got < 2 * n
    assert tps.block_bytes(sizes[-1]) == 1 << 27        # 4096 x 1024


@pytest.mark.parametrize("f,p,kind", list(_cases()))
def test_packed_views_decide_as_the_reference(f, p, kind):
    """The eleven host inputs packed into an ordinary numpy block at
    ``staging_layout``: the plain K1 on the views (float32) equals the JAX
    package's fused decision (float32) and the NumPy host cascade
    (float64), choice and ok exact; the views hold ``as_tensor``'s casts."""
    for i, w in enumerate(WEIGHTS):
        c = make_case(7000 * f + p + i, f, p, kind, w)
        w = c["energy_weight"]
        fused = [c[k] for k in FUSED_ARGS]
        nbytes = tps.staging_layout(f, p)[1]
        buf = np.full(tps.block_bytes(nbytes), 0xAB, np.uint8)
        views = tps.pack_inputs(buf, *fused)
        assert set(views) == {n for n, _, _ in tps.STAGED_ARRAYS}
        packed = [torch.from_numpy(views[k]) for k in FUSED_ARGS]
        for got, want in zip(packed, tt(*fused)):
            assert got.dtype == want.dtype and torch.equal(
                got.nan_to_num(), want.nan_to_num())
        res = tps.fused_composite_decide(*packed, w)
        same(res, jps.fused_composite_decide(*fused, w))
        same(res, host_composite(c))


def test_packing_refuses_what_the_layout_does_not_hold():
    c = make_case(1, 4, 5, "random")
    fused = [c[k] for k in FUSED_ARGS]
    buf = np.zeros(tps.block_bytes(tps.staging_layout(4, 5)[1]), np.uint8)
    bad = list(fused)
    bad[0] = fused[0][0]                       # (P,) would broadcast
    with pytest.raises(ValueError, match="ewma_v"):
        tps.pack_inputs(buf, *bad)
    with pytest.raises(ValueError, match="11 inputs"):
        tps.pack_inputs(buf, *fused[:10])
    with pytest.raises(ValueError, match="staging block"):
        tps.pack_inputs(buf[:64], *fused)
    with pytest.raises(ValueError, match="CUDA"):
        tps.fused_composite_decide_staged(*fused, 0.1, device="cpu")
    assert tps._STAGING.host is None            # no block on the CPU
    assert tps.fused_composite_decide_cuda.launches == 0
