"""The port's SSD chunked scan (the plain version, which ``ops.ssd_scan``
runs for CPU tensors) against the JAX package's Pallas kernel (interpret
mode, as tests/test_kernels.py runs it) and its sequential oracle, on the
same numpy-seeded inputs.

Tolerance: atol 1e-4, that of tests/test_kernels.py (all f32; |y| is about
1 with these inputs, and the chunked and sequential sums differ by ~5e-6).
The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against the plain version there. Its bf16 route rounds where the plain
version does not (bf16 hi + lo parts of the weights, the scaled x and the
state); ``_kernel_rounding`` emulates that on the cases of
tests/ssd_scan_cases.py and holds it to the card's tolerance.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import ssd_scan_cases as ssd_cases  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402

ATOL = 1e-4


def _inputs(seed, b, s, h, p, g, n, dt_scale=0.1):
    """x, dt, A, B, C as in tests/test_kernels.py, in both frameworks."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p))
    dt = np.abs(rng.normal(size=(b, s, h))) * dt_scale + 0.01
    A = -np.abs(rng.normal(size=h)) - 0.1
    Bm, Cm = rng.normal(size=(b, s, g, n)), rng.normal(size=(b, s, g, n))
    arrs = [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 32, 2, 16, 32),
    (1, 256, 8, 16, 1, 32, 64),
])
def test_ssd_scan_matches_pallas_and_oracle(b, s, h, p, g, n, chunk):
    j, t = _inputs(s + h, b, s, h, p, g, n)
    y, fin = ops.ssd_scan(*t, chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (b, s, h, p)
    assert fin.dtype == torch.float32 and fin.shape == (b, h, p, n)
    jy, jfin = jops.ssd_scan(*j, chunk=chunk)
    _close(y, jy)
    _close(fin, jfin)
    wy, wfin = jref.ssd_ref(*j)
    _close(y, wy)
    _close(fin, wfin)
    # the port's own oracle is the JAX oracle's twin
    ry, rfin = ref.ssd_ref(*t)
    _close(ry, wy)
    _close(rfin, wfin)


def test_ssd_scan_chunk_invariance():
    """The output must not depend on the chunk size (algebraic identity)."""
    _, t = _inputs(5, 1, 128, 2, 16, 1, 16)
    y32, f32 = ops.ssd_scan(*t, chunk=32)
    y64, f64 = ops.ssd_scan(*t, chunk=64)
    y128, _ = ops.ssd_scan(*t, chunk=128)
    _close(y32, y64)
    _close(y32, y128)
    _close(f32, f64)


def test_ssd_scan_large_decay_does_not_overflow():
    """dt*A sums to -256 over a 64-step chunk: exp(cum_i - cum_j) above the
    diagonal would be exp(+256) = inf in f32. The plain version masks the
    exponent, not the exponential, and matches the sequential oracle."""
    _, t = _inputs(6, 1, 128, 2, 16, 1, 16)
    x, _, _, Bm, Cm = t
    dt = torch.full((1, 128, 2), 2.0)
    A = torch.tensor([-2.0, -0.5])
    y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    wy, wfin = ref.ssd_ref(x, dt, A, Bm, Cm)
    _close(y, wy)
    _close(fin, wfin)


def test_ssd_scan_bf16_inputs_give_bf16_y():
    """As the Pallas kernel: y in x's dtype, the state in f32."""
    _, t = _inputs(7, 1, 64, 2, 16, 1, 16)
    x, dt, A, Bm, Cm = t
    y, fin = ops.ssd_scan(x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(),
                          chunk=16)
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    yf, _ = ops.ssd_scan(x.bfloat16().float(), dt, A, Bm.bfloat16().float(),
                         Cm.bfloat16().float(), chunk=16)
    # one bf16 rounding of the same f32 result
    np.testing.assert_allclose(y.float().numpy(), yf.numpy(), rtol=2 ** -8,
                               atol=1e-6)


def test_model_ssd_chunked_matches_oracle():
    """The model's plain route (ssd_chunked) against both packages."""
    j, t = _inputs(8, 2, 128, 4, 16, 2, 16)
    y, fin = tm.ssd_chunked(*t, 32, return_final_state=True)
    jy, jfin = jm.ssd_chunked(*j, 32, return_final_state=True)
    _close(y, jy)
    _close(fin, jfin)
    _close(y, jref.ssd_ref(*j)[0])


def test_kernel_wrapper_takes_cuda_tensors_only():
    _, t = _inputs(9, 1, 64, 2, 16, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_cuda(*t, chunk=16)
    assert ssd.ssd_scan_cuda.launches == 0
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd_scan(*t, chunk=48)


# ---------------------------------------------------------------------------
# The bf16 kernel's rounding, emulated on the CPU
# ---------------------------------------------------------------------------

# the card's bf16 tolerance of the kernel against its plain version
# (tests/test_torch_cuda.py, chip_smoke.py): y within frac * mean|y| +
# rtol * |y|, the final state within the f32 one
CARD_TOL = {"y": (1e-3, 2 ** -7), "state": (1e-4, 1e-5)}


def _hi(t):
    return t.bfloat16().float()


def _lo(t):
    return (t - _hi(t)).bfloat16().float()


def _kernel_rounding(x, dt, A, Bm, Cm, chunk):
    """The bf16 kernel's function, rounded where it rounds: x, B and C are
    bf16 values, so their products are exact in f32; C.B^T in f32 once per
    group; the weights W = C.B^T o L o dt in f32, with the decay only where
    i >= j, split into bf16 hi + lo for the product with x; the chunk state
    from x dt e^{total - cum} split into hi + lo, times B; the state entering
    each chunk stored as bf16 hi + lo for C . state; y rounded once to bf16,
    the final state f32. (Below the diagonal tile the kernel factors the
    f32 decay through the tile's last cumsum, a rounding of order 1e-7 that
    this emulation leaves out.)"""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hpg = h // g
    xf, bf, cf = x.float(), Bm.float(), Cm.float()
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    state = torch.zeros(b, h, p, n)
    ys = []
    for c0 in range(0, s, chunk):
        xc = xf[:, c0:c0 + chunk].permute(0, 2, 1, 3)        # (B,H,Q,P)
        dtc = dt[:, c0:c0 + chunk].float().permute(0, 2, 1)  # (B,H,Q)
        bc, cc = bf[:, c0:c0 + chunk], cf[:, c0:c0 + chunk]  # (B,Q,G,N)
        cum = torch.cumsum(dtc * A.float()[None, :, None], dim=2)
        total = cum[:, :, -1]
        cb = torch.einsum("bign,bjgn->bgij", cc, bc)         # once per group
        cb = cb.repeat_interleave(hpg, dim=1)                # (B,H,Q,Q)
        diff = cum[:, :, :, None] - cum[:, :, None, :]
        w = cb * torch.exp(torch.where(tri, diff, float("-inf")))
        w = w * dtc[:, :, None, :]
        y = _hi(w) @ xc + _lo(w) @ xc
        ch = cc.repeat_interleave(hpg, dim=2).permute(0, 2, 1, 3)
        st = state.transpose(-1, -2)                         # (B,H,N,P)
        y = y + (ch @ _hi(st) + ch @ _lo(st)) * torch.exp(cum)[..., None]
        xs = xc * (dtc * torch.exp(total[..., None] - cum))[..., None]
        bh = bc.repeat_interleave(hpg, dim=2).permute(0, 2, 1, 3)
        s_c = (_hi(xs).transpose(-1, -2) @ bh
               + _lo(xs).transpose(-1, -2) @ bh)             # (B,H,P,N)
        state = state * torch.exp(total)[..., None, None] + s_c
        ys.append(y.permute(0, 2, 1, 3).bfloat16())
    return torch.cat(ys, dim=1), state


def _bf16_case(case, large_decay=False):
    b, s, h, p, g, n, chunk = case
    x, dt, A, Bm, Cm = ssd_cases.inputs(*case, large_decay=large_decay)
    return (torch.from_numpy(x).bfloat16(), torch.from_numpy(dt).float(),
            torch.from_numpy(A).float(), torch.from_numpy(Bm).bfloat16(),
            torch.from_numpy(Cm).bfloat16(), chunk)


def _of_card_limit(got, want, tol):
    """max |got - want| / (frac * mean|want| + rtol * |want|)."""
    frac, rtol = tol
    got, want = got.float(), want.float()
    limit = frac * want.abs().mean() + rtol * want.abs()
    return float(((got - want).abs() / limit).max())


@pytest.mark.parametrize("large_decay,case",
                         [(False, c) for c in ssd_cases.CASES]
                         + [(True, ssd_cases.LARGE_DECAY)])
def test_bf16_rounding_stays_within_the_card_tolerance(case, large_decay):
    """Every shared case (and the large decay): the emulated kernel lands
    within the card's tolerance of the plain version, y and final state.
    The f32 values of the two agree to ~1e-6 of |y|; what reaches the limit
    (0.70-0.96 of it on these cases) is one bf16 step of y where the two f32
    values straddle a rounding boundary just above a power of two (16.1875
    rounds to 16.125 on one side and to 16.25 on the other at S=1024), which
    no f32 computation rounded once to bf16 avoids, and which stays below
    the limit (atol > 0). The state stays within 0.45 of its f32 limit."""
    x, dt, A, Bm, Cm, chunk = _bf16_case(case, large_decay)
    y, fin = _kernel_rounding(x, dt, A, Bm, Cm, chunk)
    assert torch.isfinite(y.float()).all() and torch.isfinite(fin).all()
    yw, finw = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    assert _of_card_limit(y, yw, CARD_TOL["y"]) <= 1.0
    assert _of_card_limit(fin, finw, CARD_TOL["state"]) <= 0.5


@pytest.mark.parametrize("case", [c for c in ssd_cases.CASES
                                  if c[1] * c[2] <= 1024])
def test_bf16_rounding_matches_pallas_and_oracle(case):
    """On the shared cases small enough for the interpreter: the emulated
    kernel against the Pallas kernel (interpret mode) and the sequential
    oracle, both fed the same bf16 values in f32, at the card's tolerance."""
    x, dt, A, Bm, Cm, chunk = _bf16_case(case)
    y, fin = _kernel_rounding(x, dt, A, Bm, Cm, chunk)
    j = [jnp.asarray(t.float().numpy()) for t in (x, dt, A, Bm, Cm)]
    jy, jfin = jops.ssd_scan(*j, chunk=chunk)
    wy, wfin = jref.ssd_ref(*j)
    for want_y, want_fin in ((jy, jfin), (wy, wfin)):
        assert _of_card_limit(y, torch.from_numpy(np.array(want_y)),
                              CARD_TOL["y"]) <= 1.0
        assert _of_card_limit(fin, torch.from_numpy(np.array(want_fin)),
                              CARD_TOL["state"]) <= 0.5
