"""The port's model layers against the JAX package's ``models/layers.py`` on
the same numpy-seeded inputs.

f32 tolerance: 1e-5 abs/rel for norms and attention (both sides compute in
f32; only summation order differs), 1e-4 for rope (XLA and PyTorch evaluate
pow/cos/sin with different f32 rounding, a few ulps of an angle up to 200
rad). bf16: 2**-7 rel (one bf16 rounding of the f32 result may land on the
neighbouring value) plus 1e-6 abs.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)


def _pair(rng, shape, dtype="f32", scale=0.5):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    j = jnp.asarray(x, jdt)
    return j, torch.from_numpy(np.array(j, np.float32)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (2, 5, 64), dtype, 2.0)
    js, ts = _pair(rng, (64,), dtype, 0.1)
    tol = F32 if dtype == "f32" else dict(atol=1e-6, rtol=2 ** -7)
    out = tl.rmsnorm(tx, ts)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(jl.rmsnorm(jx, js)), **tol)
    np.testing.assert_allclose(_np(tl.qk_norm(tx, ts)),
                               _np(jl.qk_norm(jx, js)), **tol)


@pytest.mark.parametrize("batched_positions", [False, True])
def test_apply_rope(batched_positions):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (2, 12, 4, 32))
    pos = (rng.integers(0, 200, (2, 12)) if batched_positions
           else np.arange(12))
    out = tl.apply_rope(tx, torch.from_numpy(pos), 1_000_000.0)
    want = jl.apply_rope(jx, jnp.asarray(pos), 1_000_000.0)
    np.testing.assert_allclose(_np(out), _np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3),
                                           (False, None)])
def test_mask_bias(causal, window):
    q_pos = np.array([[3, 4], [7, 8]])
    k_pos = np.array([[0, 1, 2, 3, 4, -1, -1, -1, -1],
                      [0, 1, 2, 3, 4, 5, 6, 7, 8]])
    out = tl._mask_bias(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                        causal, window)
    want = jl._mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos), causal,
                         window)
    assert tuple(out.shape) == want.shape
    np.testing.assert_array_equal(_np(out), _np(want))


@pytest.mark.parametrize("window", [None, 5])
def test_attend_with_empty_slots(window):
    """Decode-shaped attention over a cache with empty (-1) slots."""
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng, (2, 1, 4, 32))
    jk, tk = _pair(rng, (2, 10, 2, 32))
    jv, tv = _pair(rng, (2, 10, 2, 32))
    q_pos = np.array([[6], [9]])
    k_pos = np.array([[0, 1, 2, 3, 4, 5, 6, -1, -1, -1], list(range(10))])
    out = tl.attend(tq, tk, tv, torch.from_numpy(q_pos),
                    torch.from_numpy(k_pos), causal=True, window=window)
    want = jl.attend(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(k_pos),
                     causal=True, window=window)
    np.testing.assert_allclose(_np(out), _np(want), **F32)


@pytest.mark.parametrize("s,t,q_chunk,causal,window,q0", [
    (48, 48, 64, True, None, 0),       # one block: plain attend
    (128, 128, 32, True, None, 0),     # exact causal prefixes
    (128, 128, 32, True, 16, 0),       # sliding-window slices
    (64, 96, 32, False, None, 0),      # general branch, non-causal
    (64, 96, 32, True, None, 32),      # general branch, offset queries
])
def test_chunked_attention(s, t, q_chunk, causal, window, q0):
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (2, s, 4, 32))
    jk, tk = _pair(rng, (2, t, 2, 32))
    jv, tv = _pair(rng, (2, t, 2, 32))
    out = tl.chunked_attention(tq, tk, tv, q0=q0, causal=causal,
                               window=window, q_chunk=q_chunk)
    want = jl.chunked_attention(jq, jk, jv, q0=q0, causal=causal,
                                window=window, q_chunk=q_chunk)
    np.testing.assert_allclose(_np(out), _np(want), **F32)


def test_gated_mlp():
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng, (2, 3, 16))
    ws = [_pair(rng, shape, scale=0.2) for shape in [(16, 24), (16, 24),
                                                      (24, 16)]]
    out = tl.gated_mlp(tx, *(w[1] for w in ws))
    want = jl.gated_mlp(jx, *(w[0] for w in ws))
    np.testing.assert_allclose(_np(out), _np(want), **F32)


def test_masked_cache_update_in_place():
    rng = np.random.default_rng(5)
    jc, tc = _pair(rng, (3, 8, 2, 16))
    jn, tn = _pair(rng, (3, 1, 2, 16))
    slot = np.array([0, 5, 7], np.int32)
    out = tl.masked_cache_update(tc, tn, torch.from_numpy(slot))
    want = jl.masked_cache_update(jc, jn, jnp.asarray(slot))
    assert out is tc                      # written in place
    np.testing.assert_array_equal(_np(out), _np(want))
