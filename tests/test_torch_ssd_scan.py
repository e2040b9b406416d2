"""The port's SSD chunked scan (the plain version, which ``ops.ssd_scan``
runs for CPU tensors) against the JAX package's Pallas kernel (interpret
mode, as tests/test_kernels.py runs it) and its sequential oracle, on the
same numpy-seeded inputs.

Tolerance: atol 1e-4, that of tests/test_kernels.py (all f32; |y| is about
1 with these inputs, and the chunked and sequential sums differ by ~5e-6).
The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against the plain version there.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

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
