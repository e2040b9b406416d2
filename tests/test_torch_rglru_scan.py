"""The port's RG-LRU linear recurrence (the plain version, which
``ops.rglru_scan`` runs for CPU tensors) against the JAX package's Pallas
kernel (interpret mode, as tests/test_kernels.py runs it) and its sequential
oracle, on the same numpy-seeded inputs; and the model's plain route (a
log-depth scan) against the JAX package's ``associative_scan``.

Tolerance: atol 2e-5, rtol 2e-4, that of tests/test_kernels.py (f32; the
Pallas kernel's log-space form rounds differently from a sequential scan).
The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against the plain version there. Here its sizing rule ``kernel_tiles`` is
held to its invariants, and its decomposition of the sequence (steps of
a tile, warp segments, chained in the kernel's order with its f32 FMAs)
is emulated and held against the plain version within the card's
tolerance, ``chip_smoke.SCALED_TOL["rglru"]``: atol 2e-5 x mean|h|, rtol
1e-5.
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


# chip_smoke.SCALED_TOL["rglru"]: (atol as a fraction of mean|h|, rtol)
CARD_TOL = (2e-5, 1e-5)


def _fma(x, y, z):
    """f32 fmaf: the product is exact in f64, the sum rounds to f64 and then
    to f32 (that double rounding differs from one rounding only on rare
    ties)."""
    return (x.double() * y.double() + z.double()).float()


def emulate_kernel(a, b):
    """The kernel's arithmetic in f32: ``kernel_tiles`` splits the sequence
    into steps of a tile and each tile into 8 warp segments (rows past S
    are zeros, as TMA fills them); each warp scans its segment from 0
    (product of a, end value), and its entering state chains the step's
    carry through the warps before its own; the carry into the next step
    chains it through all 8; the rescan starts from the entering state."""
    bs, s, w = a.shape
    tile, _stages = rg.kernel_tiles(s)
    per = tile // rg.WARPS
    steps = -(-s // tile)
    shape = (bs, steps, rg.WARPS, per, w)
    a5 = torch.nn.functional.pad(a, (0, 0, 0, steps * tile - s)).reshape(shape)
    b5 = torch.nn.functional.pad(b, (0, 0, 0, steps * tile - s)).reshape(shape)
    prod = torch.ones(shape[:3] + (w,))
    end = torch.zeros(shape[:3] + (w,))
    for i in range(per):
        end = _fma(a5[..., i, :], end, b5[..., i, :])
        prod = prod * a5[..., i, :]
    hin = torch.empty_like(end)
    carry = torch.zeros(bs, w)
    for t in range(steps):
        for u in range(rg.WARPS):
            hin[:, t, u] = carry
            carry = _fma(prod[:, t, u], carry, end[:, t, u])
    h = torch.empty(shape)
    x = hin
    for i in range(per):
        x = _fma(a5[..., i, :], x, b5[..., i, :])
        h[..., i, :] = x
    return h.reshape(bs, -1, w)[:, :s]


@pytest.mark.parametrize("b,s,w", [
    (1, 1024, 4096),     # recurrentgemma-9b's prefill at full width
    (1, 256, 4096),      # a serving bucket
    (2, 100, 64), (1, 5, 32), (1, 1, 32),
    (1, 5000, 64),       # forty steps
])
def test_kernel_decomposition_stays_within_the_card_tolerance(b, s, w):
    """The model's gates (a in [0.9, 1), b normal), as chip_smoke.py draws
    them at full width."""
    rng = np.random.default_rng(s + w)
    a = torch.from_numpy(rng.uniform(0.9, 1.0, (b, s, w))).float()
    bb = torch.from_numpy(rng.normal(size=(b, s, w))).float()
    want = rg.rglru_scan_plain(a, bb)
    got = emulate_kernel(a, bb)
    frac, rtol = CARD_TOL
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=frac * float(want.abs().mean()))


def test_kernel_tiles_cover_the_sequence_once():
    """Every S up to 4200 and a few long ones: the steps of a tile cover
    [0, S) once, the last step holds a row of S, and the ring fits the
    kernel's limits and holds no more tiles than there are steps."""
    for s in list(range(1, 4200)) + [5000, 16384, 100_000]:
        tile, stages = rg.kernel_tiles(s)
        assert rg.WARPS <= tile <= rg.MAX_TILE and tile % rg.WARPS == 0
        steps = -(-s // tile)
        assert (steps - 1) * tile < s <= steps * tile
        assert 1 <= stages <= min(rg.MAX_STAGES, steps)
        # dynamic shared memory: a and b of every stage, within 220 KB
        assert stages * 2 * tile * 32 * 4 + 128 <= 220 * 1024
        if s <= tile:
            assert (tile, stages) == (-(-s // rg.WARPS) * rg.WARPS, 1)


def test_kernel_tiles_at_the_serving_shapes():
    """256 rows a step with 3 in flight up to S = 1024, 128 rows with 2
    beyond; a prompt of at most 256 tokens takes one tile of its own
    length; S = 0 is refused."""
    assert rg.kernel_tiles(1024) == (256, 3)
    assert rg.kernel_tiles(768) == (256, 3)
    assert rg.kernel_tiles(512) == (256, 2)
    assert rg.kernel_tiles(256) == (256, 1)
    assert rg.kernel_tiles(100) == (104, 1)
    assert rg.kernel_tiles(16) == (16, 1)
    assert rg.kernel_tiles(5) == (8, 1)
    assert rg.kernel_tiles(4096) == (128, 2)
    assert rg.kernel_tiles(5000) == (128, 2)
    with pytest.raises(ValueError, match="S >= 1"):
        rg.kernel_tiles(0)
