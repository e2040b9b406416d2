"""The port's RG-LRU linear recurrence (the plain version, which
``ops.rglru_scan`` runs for CPU tensors) against the JAX package's Pallas
kernel (interpret mode, as tests/test_kernels.py runs it) and its sequential
oracle, on the same numpy-seeded inputs; and the model's plain route (a
log-depth scan) against the JAX package's ``associative_scan``.

Tolerance: atol 2e-5, rtol 2e-4, that of tests/test_kernels.py (f32; the
Pallas kernel's log-space form rounds differently from a sequential scan).
The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against the plain version there.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-4)


def _inputs(seed, b, s, w):
    """a in (0.01, 0.99) and b normal, as in tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.normal(size=(b, s, w)))) * 0.98
         + 0.01).astype(np.float32)
    bb = rng.normal(size=(b, s, w)).astype(np.float32)
    return (jnp.asarray(a), jnp.asarray(bb)), (torch.from_numpy(a),
                                               torch.from_numpy(bb))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("b,s,w,chunk,wb", [
    (1, 64, 32, 16, 32),
    (2, 128, 64, 32, 32),
    (1, 256, 128, 64, 128),
])
def test_rglru_scan_matches_pallas_and_oracle(b, s, w, chunk, wb):
    (ja, jb), (a, bb) = _inputs(s + w, b, s, w)
    h = ops.rglru_scan(a, bb, chunk=chunk, width_block=wb)
    assert h.dtype == torch.float32 and h.shape == (b, s, w)
    _close(h, jops.rglru_scan(ja, jb, chunk=chunk, width_block=wb))
    _close(h, jref.rglru_ref(ja, jb))
    _close(ref.rglru_ref(a, bb), jref.rglru_ref(ja, jb))


@pytest.mark.parametrize("s", [1, 5, 64, 100])
def test_model_plain_scan_matches_associative_scan(s):
    """The model's plain route (use_pallas off): a log-depth scan, as the
    JAX package's ``jax.lax.associative_scan``, for sequences of any
    length."""
    (ja, jb), (a, bb) = _inputs(s, 2, s, 16)
    got = trg.rglru_scan(a, bb, use_pallas=False)
    _close(got, jrg.rglru_scan(ja, jb, use_pallas=False))
    _close(got, rg.rglru_scan_plain(a, bb))


def test_model_kernel_route_matches_pallas_route():
    (ja, jb), (a, bb) = _inputs(3, 1, 128, 64)
    _close(trg.rglru_scan(a, bb, use_pallas=True),
           jrg.rglru_scan(ja, jb, use_pallas=True))


def test_gates_match():
    rng = np.random.default_rng(4)
    w, h = 32, 4
    p = {"gate_a": rng.normal(size=(h, w // h, w // h)) * 0.3,
         "gate_x": rng.normal(size=(h, w // h, w // h)) * 0.3,
         "gate_a_b": rng.normal(size=w) * 0.1,
         "gate_x_b": rng.normal(size=w) * 0.1,
         "lam": rng.normal(size=w)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    bx = rng.normal(size=(2, 6, w)).astype(np.float32)
    ja, jb = jrg.rglru_gates({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(bx))
    ta, tb = trg.rglru_gates({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(bx))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6,
                               rtol=1e-5)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 81).astype(np.float32)
    np.testing.assert_allclose(trg._gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               atol=1e-6)


def test_kernel_wrapper_takes_cuda_tensors_only():
    _, (a, bb) = _inputs(5, 1, 16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        rg.rglru_scan_cuda(a, bb)
    assert rg.rglru_scan_cuda.launches == 0
    with pytest.raises(ValueError, match="one shape"):
        ops.rglru_scan(a, bb[:, :8])
