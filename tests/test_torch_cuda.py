"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip elsewhere (a CUDA kernel has no CPU
mode). They import neither JAX nor the JAX package, so they run on a machine
that has only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances (atol, rtol): f32 2e-5, that of tests/test_kernels.py. bf16
2e-4 and 2**-7: kernel and plain version both compute in f32 and round the
output once, so they differ by at most one bf16 step (2**-7 of the value),
and 2e-4 stays well under a typical |out| (about 1e-2 at S=1024).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = {"f32": (2e-5, 2e-5), "bf16": (2e-4, 2 ** -7)}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False); the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,h,kh,d,causal,window", [
    (128, 4, 4, 32, True, None),
    (256, 8, 2, 64, True, None),
    (256, 4, 2, 32, True, 96),
    (128, 4, 4, 32, False, None),
    (100, 4, 2, 32, True, 40),
    (1024, 16, 8, 128, True, None),
])
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, s, h, kh,
                                              d, causal, window):
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.normal(size=shape) * 0.3).to(
        cuda_device, TORCH[dtype])
        for shape in [(1, s, h, d), (1, s, kh, d), (1, s, kh, d)])
    before = fa.flash_attention_cuda.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 16, 4, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q, q[:, :, :2].contiguous(),
                                q[:, :, :2].contiguous())
    q = torch.zeros(1, 16, 4, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fa.flash_attention_cuda(q, q, q)
