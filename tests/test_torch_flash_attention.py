"""The port's flash attention (plain PyTorch version on CPU tensors) against
the JAX package's Pallas kernel (interpret mode, as tests/test_kernels.py
runs it) and its oracle, on the same numpy-seeded inputs.

Tolerances are those of tests/test_kernels.py: f32 2e-5 (abs and rel), bf16
2e-2. The kernel itself runs only on the card: tests/test_torch_cuda.py holds
it against the plain version there.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"f32": 2e-5, "bf16": 2e-2}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    """The same values in both frameworks: numpy draws, rounded once to the
    working dtype and carried across through float32."""
    rng = np.random.default_rng(seed)
    outs = []
    for shape in shapes:
        x = jnp.asarray(rng.normal(size=shape) * 0.3, JNP[dtype])
        outs.append((x, torch.from_numpy(np.array(x, np.float32)).to(
            TORCH[dtype])))
    return outs


def _close(got, want, tol):
    if isinstance(want, torch.Tensor):
        want = want.float().cpu().numpy()
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kh,d,qb,kb", [
    (1, 128, 4, 4, 32, 64, 64),       # MHA
    (2, 256, 8, 2, 64, 64, 128),      # GQA, rectangular blocks
    (1, 64, 4, 1, 32, 64, 32),        # MQA, single q block
    (1, 128, 16, 1, 256, 64, 64),     # the hybrid's local attention: MQA,
])                                    # head_dim 256
def test_flash_attention_causal_matches_pallas(dtype, b, s, h, kh, d, qb,
                                               kb):
    (jq, q), (jk, k), (jv, v) = _inputs(
        s + h, [(b, s, h, d), (b, s, kh, d), (b, s, kh, d)], dtype)
    out = ops.flash_attention(q, k, v, causal=True, q_block=qb, kv_block=kb)
    assert out.dtype == TORCH[dtype] and out.shape == (b, s, h, d)
    _close(out, jops.flash_attention(jq, jk, jv, causal=True, q_block=qb,
                                     kv_block=kb), TOL[dtype])
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=True),
           TOL[dtype])
    _close(out, ref.flash_attention_ref(q, k, v, causal=True), TOL[dtype])


@pytest.mark.parametrize("window", [32, 96, 1024])
def test_flash_attention_windowed_matches_pallas(window):
    (jq, q), (jk, k), (jv, v) = _inputs(
        window, [(2, 256, 4, 32), (2, 256, 2, 32), (2, 256, 2, 32)], "f32")
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              q_block=64, kv_block=64)
    _close(out, jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                     q_block=64, kv_block=64), TOL["f32"])
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=True,
                                         window=window), TOL["f32"])


def test_flash_attention_noncausal_matches_pallas():
    (jq, q), (jk, k), (jv, v) = _inputs(
        7, [(1, 128, 4, 32), (1, 128, 4, 32), (1, 128, 4, 32)], "f32")
    out = ops.flash_attention(q, k, v, causal=False, q_block=64, kv_block=64)
    _close(out, jops.flash_attention(jq, jk, jv, causal=False, q_block=64,
                                     kv_block=64), TOL["f32"])
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=False),
           TOL["f32"])


@pytest.mark.parametrize("s,qb,kb,causal,window", [
    (100, 64, 48, True, None),
    (100, 32, 64, True, 40),
    (77, 64, 64, False, None),
    (16, 128, 128, True, None),       # the engine's smallest bucket
])
def test_flash_attention_ragged_edges_match_oracle(s, qb, kb, causal,
                                                   window):
    """Sequences that no block divides: the Pallas kernel asserts them away,
    the port masks (plain version) and slices them, against the oracle."""
    (jq, q), (jk, k), (jv, v) = _inputs(
        s, [(1, s, 4, 32), (1, s, 2, 32), (1, s, 2, 32)], "f32")
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_block=qb, kv_block=kb)
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                         window=window), TOL["f32"])


def test_kernel_wrapper_takes_cuda_tensors_only():
    q = torch.zeros(1, 16, 4, 32)
    k = torch.zeros(1, 16, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, k, causal=True)
    assert fa.flash_attention_cuda.launches == 0


def test_shapes_are_checked():
    q = torch.zeros(1, 16, 4, 32)
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 16, 3, 32),
                            torch.zeros(1, 16, 3, 32))


def test_flash_attention_d256_window_masks():
    """The hybrid family's shape (16 q heads, 1 kv head, head_dim 256) with
    a window shorter than the sequence."""
    (jq, q), (jk, k), (jv, v) = _inputs(
        11, [(1, 192, 16, 256), (1, 192, 1, 256), (1, 192, 1, 256)], "f32")
    out = ops.flash_attention(q, k, v, causal=True, window=64, q_block=64,
                              kv_block=64)
    _close(out, jops.flash_attention(jq, jk, jv, causal=True, window=64,
                                     q_block=64, kv_block=64), TOL["f32"])
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=True, window=64),
           TOL["f32"])
