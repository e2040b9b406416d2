"""The port's model layers against the JAX package's ``models/layers.py`` on
the same numpy-seeded inputs.

f32 tolerance: 1e-5 abs/rel for norms, attention and the causal conv (both
sides compute in f32; only summation order differs), 1e-4 for rope (XLA and PyTorch evaluate
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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 3, 17])
def test_causal_conv1d(dtype, s):
    """Depthwise K=4 causal conv, computed in f32 and cast to x's dtype; s
    shorter than K too."""
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng, (2, s, 24), dtype)
    jw, tw = _pair(rng, (24, 4), dtype)
    out = tl.causal_conv1d(tx, tw)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    tol = F32 if dtype == "f32" else dict(atol=1e-6, rtol=2 ** -7)
    np.testing.assert_allclose(_np(out), _np(jl.causal_conv1d(jx, jw)),
                               **tol)


@pytest.mark.parametrize("x_dtype,buf_dtype", [
    ("f32", "f32"),      # mamba2's cache is f32 throughout
    ("bf16", "f32"),     # bf16 weights over mamba2's f32 cache
    ("bf16", "bf16"),    # the hybrid's bf16 conv buffers
    ("f32", "bf16"),     # f32 weights over the hybrid's bf16 buffers
])
def test_conv1d_step(x_dtype, buf_dtype):
    """One decode step of the conv: the new buffer takes JAX's promotion of
    concat(buf, x_t), the output x_t's dtype; and steps chained from a
    zero buffer equal the full causal conv."""
    rng = np.random.default_rng(7)
    jx, tx = _pair(rng, (2, 24), x_dtype)
    jb, tb = _pair(rng, (2, 3, 24), buf_dtype)
    jw, tw = _pair(rng, (24, 4), x_dtype)
    y, buf = tl.conv1d_step(tx, tb, tw)
    jy, jbuf = jl.conv1d_step(jx, jb, jw)
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    assert names[y.dtype] == str(jy.dtype)
    assert names[buf.dtype] == str(jbuf.dtype)
    tol = F32 if x_dtype == "f32" else dict(atol=1e-6, rtol=2 ** -7)
    np.testing.assert_allclose(_np(y), _np(jy), **tol)
    np.testing.assert_array_equal(_np(buf), _np(jbuf))

    xs = torch.from_numpy(rng.normal(size=(2, 6, 24)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(24, 4)).astype(np.float32))
    state = torch.zeros(2, 3, 24)
    steps = []
    for t in range(6):
        out, state = tl.conv1d_step(xs[:, t], state, w)
        steps.append(out)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               tl.causal_conv1d(xs, w).numpy(), **F32)
