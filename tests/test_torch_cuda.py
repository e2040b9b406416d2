"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip elsewhere (a CUDA kernel has no CPU
mode). They import neither JAX nor the JAX package, so they run on a machine
that has only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances (atol, rtol), those of chip_smoke.py:

* flash attention: f32 2e-5, that of tests/test_kernels.py. bf16 2e-4 and
  2**-7: the plain version computes in f32 and rounds the output once; the
  kernel computes scores, softmax and sums in f32 and feeds P to the tensor
  cores as bf16 hi + lo parts, which on the CPU stays within 0.89 of this
  limit (tests/test_torch_flash_attention.py); 2e-4 stays well under a
  typical |out| (about 1e-2 at S=1024, 5e-3 at D=256 under a 2048
  window).
* decode attention: those of flash attention, for the same reason (kernel
  and plain version compute in f32 and round the output once); a typical
  |out| is about 0.06 at these 0.3-scale inputs and 0.015-0.02 at the
  serving shapes.
* SSD scan: f32 1e-4 x mean|out| and 1e-5 (the plain f32 chunked scan is
  3.6e-5 from a float64 one at full width, where mean|y| is 3.1: 1.2e-5 of
  the mean); bf16 y 1e-3 x mean|out| and 2**-7 (one bf16 rounding of the
  same f32 value; the bf16 kernel's hi + lo products, emulated on the CPU,
  stay within it on every case of tests/ssd_scan_cases.py). The final
  state is f32 either way.
* RG-LRU scan: 2e-5 x mean|out| and 1e-5 (the kernel chains the steps of
  a block's walk and the warp segments of each step; emulated in f32 on
  the CPU, tests/test_torch_rglru_scan.py, that stays within 0-0.07 of this
  limit at S=1-5000, where mean|h| is about 2.5).
* policy-score kernels (K1, K2): bit-equal choice and ok. The kernels round
  every multiply and add apart, in the plain version's association, so
  nothing in the arithmetic differs.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from decode_attention_cases import CASES, SERVING, serving_case  # noqa: E402
from flash_attention_cases import CARD_CASES, card_inputs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import policy_score as ps  # noqa: E402
from policy_score_cases import (  # noqa: E402
    FUSED_ARGS, KINDS, PREBUILT_ARGS, make_case, prebuilt_columns)
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
import ssd_scan_cases  # noqa: E402

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
@pytest.mark.parametrize("b,s,t,h,kh,d,causal,window", CARD_CASES)
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, b, s, t, h,
                                              kh, d, causal, window):
    q, k, v = (torch.from_numpy(x).to(cuda_device, TORCH[dtype])
               for x in card_inputs(b, s, t, h, kh, d))
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


@pytest.mark.cuda
def test_flash_attention_kernel_takes_head_dim_96(cuda_device):
    """head_dim 96 (phi-3-vision) has an instance; 80 has none and raises."""
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, 64, 4, 96, device=cuda_device, dtype=dtype)
        out = fa.flash_attention_cuda(q, q, q)
        torch.cuda.synchronize()
        assert out.shape == q.shape and bool(torch.isfinite(out).all())
    q = torch.zeros(1, 64, 4, 80, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q, q, q)


# the families of this slice at reduced width: (arch, config overrides, K3
# launches a prefill, dtypes). The MoE models run in f32 only: in bf16 the
# two routes' roundings may move a router near-tie to another expert
# (chip_smoke.py's phase 7 replays the experts for that reason)
FAMILY_CASES = [("mixtral-8x7b", {}, 2, ["f32"]),
                ("dbrx-132b", {}, 2, ["f32"]),
                ("phi-3-vision-4.2b", {"head_dim": 96}, 2, ["f32", "bf16"]),
                ("whisper-small", {}, 0, ["f32", "bf16"])]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,overrides,k3,dtype", [
    (a, o, k, d) for a, o, k, ds in FAMILY_CASES for d in ds])
def test_family_prefill_kernel_route_matches_plain(cuda_device, arch,
                                                   overrides, k3, dtype):
    """Reduced-width MoE, VLM (head_dim 96) and whisper prefill on the card
    through the kernel route (K3 once a layer; whisper has no kernel route)
    against the plain route on the same weights and batch: f32 at 2e-5 abs
    and rel, bf16 at 2**-5 of the largest plain logit (tests/
    test_torch_model.py's bf16 tolerance)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_api as api
    from repro_torch.models import params as pm
    cfg = get_config(arch).reduced().replace(use_pallas=True, **overrides)
    params = pm.init(api.model_specs(cfg),
                     torch.Generator(device=cuda_device).manual_seed(0),
                     TORCH[dtype], cuda_device)
    batch = api.make_batch(cfg, InputShape("card", 128, 2, "prefill"),
                           np.random.default_rng(0), device=cuda_device)
    before = fa.flash_attention_cuda.launches
    got, _ = api.prefill(cfg, params, batch)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + k3
    want, _ = api.prefill(cfg.replace(use_pallas=False), params, batch)
    assert bool(torch.isfinite(got).all())
    if dtype == "f32":
        tol = dict(atol=2e-5, rtol=2e-5)
    else:
        tol = dict(atol=2 ** -5 * float(want.float().abs().max()), rtol=0)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES) + list(SERVING))
def test_decode_attention_kernel_matches_plain(cuda_device, dtype, case):
    b, t, h, kh, d, splits, kv_block, lengths = (
        CASES[case] if case in CASES else serving_case(case))
    rng = np.random.default_rng(t + h)
    q, k, v = (torch.from_numpy(rng.normal(size=shape) * 0.3).to(
        cuda_device, TORCH[dtype])
        for shape in [(b, h, d), (b, t, kh, d), (b, t, kh, d)])
    lens = (rng.integers(1, t + 1, b) if lengths is None
            else np.array(lengths))
    lens = torch.from_numpy(lens).to(cuda_device, torch.int32)
    before = da.decode_attention_cuda.launches
    out = ops.decode_attention(q, k, v, lens, splits=splits,
                               kv_block=kv_block)
    torch.cuda.synchronize()
    assert da.decode_attention_cuda.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out).all()
    want = da.decode_attention_plain(q, k, v, lens, splits=splits,
                                     kv_block=kv_block)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)


def _decode_case(name, dtype, device):
    b, t, h, kh, d, splits, kv_block, lengths = (
        CASES[name] if name in CASES else serving_case(name))
    rng = np.random.default_rng(t + h)
    q, k, v = (torch.from_numpy(rng.normal(size=shape) * 0.3).to(
        device, TORCH[dtype])
        for shape in [(b, h, d), (b, t, kh, d), (b, t, kh, d)])
    lens = (rng.integers(1, t + 1, b) if lengths is None
            else np.array(lengths))
    return q, k, v, torch.from_numpy(lens).to(device, torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,case", [("bf16", "d128"), ("bf16", "d256"),
                                        ("bf16", "g64"), ("bf16", "g48_d256"),
                                        ("f32", "edges")])
def test_decode_attention_is_one_launch(cuda_device, dtype, case):
    """One kernel on the card a call: the splits combine in their cluster,
    with no second kernel and no scratch to clear."""
    q, k, v, lens = _decode_case(case, dtype, cuda_device)
    ops.decode_attention(q, k, v, lens)              # built and warm
    names = _build.graph_kernels(lambda: ops.decode_attention(q, k, v, lens))
    assert len(names) == 1 and "decode_" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d128", "d256"])
def test_decode_attention_graph_replays_the_same_output(cuda_device, case):
    """A CUDA graph of one call, replayed twice, gives the eager call's
    output both times: no state is left on the card between calls."""
    q, k, v, lens = _decode_case(case, "bf16", cuda_device)
    eager = ops.decode_attention(q, k, v, lens)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.decode_attention(q, k, v, lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, lens)
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, eager) and torch.equal(out, eager)


@pytest.mark.cuda
def test_decode_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(2, 4, 32, device=cuda_device)
    kv = torch.zeros(2, 128, 2, 32, device=cuda_device)
    lens = torch.ones(2, dtype=torch.int32, device=cuda_device)
    before = da.decode_attention_cuda.launches
    with pytest.raises(ValueError, match="f32 or bf16"):
        da.decode_attention_cuda(q.half(), kv.half(), kv.half(), lens)
    with pytest.raises(ValueError, match="f32 or bf16"):
        da.decode_attention_cuda(q, kv.bfloat16(), kv.bfloat16(), lens)
    with pytest.raises(ValueError, match="CUDA tensors"):
        da.decode_attention_cuda(q, kv, kv, lens.cpu())
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention_cuda(q, kv, kv, lens.long())
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention_cuda(q[..., :24].contiguous(),
                                 kv[..., :24].contiguous(),
                                 kv[..., :24].contiguous(), lens)
    with pytest.raises(ValueError, match="head_dim"):
        wide = torch.zeros(2, 130, 32, device=cuda_device)
        da.decode_attention_cuda(wide, kv[:, :, :1].contiguous(),
                                 kv[:, :, :1].contiguous(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention_cuda(q, kv.transpose(0, 1).contiguous()
                                 .transpose(0, 1), kv, lens)
    with pytest.raises(ValueError, match="T=1000"):
        big = torch.zeros(2, 1000, 2, 32, device=cuda_device)
        da.decode_attention_cuda(q, big, big, lens)
    assert da.decode_attention_cuda.launches == before


def _close_scaled(got, want, frac, rtol):
    """|got - want| <= frac * mean|want| + rtol * |want|."""
    want = want.float()
    atol = frac * float(want.abs().mean())
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


SSD_TOL = {"f32": (1e-4, 1e-5), "bf16": (1e-3, 2 ** -7)}


def _ssd_inputs(case, dtype, device, large_decay=False):
    x, dt, A, Bm, Cm = ssd_scan_cases.inputs(*case, large_decay=large_decay)
    return (torch.from_numpy(x).to(device, TORCH[dtype]),
            torch.from_numpy(dt).float().to(device),
            torch.from_numpy(A).float().to(device),
            torch.from_numpy(Bm).to(device, TORCH[dtype]),
            torch.from_numpy(Cm).to(device, TORCH[dtype]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", ssd_scan_cases.CASES)
def test_ssd_scan_kernel_matches_plain(cuda_device, dtype, b, s, h, p, g, n,
                                       chunk):
    x, dt, A, Bm, Cm = _ssd_inputs((b, s, h, p, g, n, chunk), dtype,
                                   cuda_device)
    before = ssd.ssd_scan_cuda.launches
    y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_cuda.launches == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape
    assert fin.dtype == torch.float32 and fin.shape == (b, h, p, n)
    yw, finw = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    _close_scaled(y, yw, *SSD_TOL[dtype])
    _close_scaled(fin, finw, *SSD_TOL["f32"])


@pytest.mark.cuda
def test_ssd_scan_bf16_large_decay_at_full_width(cuda_device):
    """mamba2-2.7b's width over two chunks with |dt*A| summing far past 88:
    the bf16 route's weights exponentiate only where i >= j."""
    case = ssd_scan_cases.LARGE_DECAY
    x, dt, A, Bm, Cm = _ssd_inputs(case, "bf16", cuda_device, True)
    y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=case[-1])
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    yw, finw = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=case[-1])
    _close_scaled(y, yw, *SSD_TOL["bf16"])
    _close_scaled(fin, finw, *SSD_TOL["f32"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernels", [("bf16", ssd.BF16_KERNELS),
                                           ("f32", 1)])
def test_ssd_scan_kernels_per_call(cuda_device, dtype, kernels):
    case = ssd_scan_cases.CASES[3]                   # a serving bucket
    x, dt, A, Bm, Cm = _ssd_inputs(case, dtype, cuda_device)
    ops.ssd_scan(x, dt, A, Bm, Cm, chunk=case[-1])
    names = _build.graph_kernels(
        lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=case[-1]))
    assert len(names) == kernels, names


@pytest.mark.cuda
def test_ssd_scan_kernel_large_decay_stays_finite(cuda_device):
    """|dt*A| sums past 88 inside a chunk: exp(cum_i - cum_j) above the
    diagonal would be inf in f32."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(1, 128, 2, 16))).float().to(
        cuda_device)
    dt = torch.full((1, 128, 2), 2.0, device=cuda_device)
    A = torch.tensor([-4.0, -0.5], device=cuda_device)
    Bm, Cm = (torch.from_numpy(rng.normal(size=(1, 128, 1, 16))).float().to(
        cuda_device) for _ in range(2))
    y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    yw, finw = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=64)
    _close_scaled(y, yw, *SSD_TOL["f32"])
    _close_scaled(fin, finw, *SSD_TOL["f32"])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w,gate", [
    (1, 64, 32, "test"),                  # tests/test_kernels.py:96-100
    (2, 128, 64, "test"),
    (1, 256, 128, "test"),
    (1, 64, 4096, "model"),               # recurrentgemma-9b's width
    (1, 1024, 4096, "model"),
    (1, 16, 4096, "model"),               # serving buckets
    (1, 256, 4096, "model"),
    (1, 512, 4096, "model"),
    (1, 300, 4096, "model"),              # a partial second tile
    (1, 768, 4096, "model"),              # three tiles in flight
    (1, 1, 32, "test"),                   # one row, one block
    (2, 5, 64, "test"),
    (1, 100, 4096, "model"),              # one tile of 104 rows
    (2, 100, 36, "test"),                 # a partial strip of columns
    (1, 5000, 64, "model"),               # forty steps of 128 rows
])
def test_rglru_scan_kernel_matches_plain(cuda_device, b, s, w, gate):
    rng = np.random.default_rng(s + w)
    if gate == "test":
        a = 1 / (1 + np.exp(-rng.normal(size=(b, s, w)))) * 0.98 + 0.01
    else:                                 # the model's a lies in [0.9, 1)
        a = rng.uniform(0.9, 1.0, size=(b, s, w))
    a = torch.from_numpy(a).float().to(cuda_device)
    bb = torch.from_numpy(rng.normal(size=(b, s, w))).float().to(cuda_device)
    before = rg.rglru_scan_cuda.launches
    h = ops.rglru_scan(a, bb)
    torch.cuda.synchronize()
    assert rg.rglru_scan_cuda.launches == before + 1
    assert h.dtype == torch.float32 and h.shape == a.shape
    _close_scaled(h, rg.rglru_scan_plain(a, bb), 2e-5, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [16, 1024, 2048])
def test_rglru_scan_is_one_kernel(cuda_device, s):
    a = torch.rand(1, s, 4096, device=cuda_device)
    bb = torch.randn(1, s, 4096, device=cuda_device)
    names = _build.graph_kernels(lambda: ops.rglru_scan(a, bb))
    assert len(names) == 1 and "rglru" in names[0], names


@pytest.mark.cuda
def test_scan_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros(1, 64, 2, 16, device=cuda_device)
    dt = torch.zeros(1, 64, 2, device=cuda_device)
    A = torch.zeros(2, device=cuda_device)
    bm = torch.zeros(1, 64, 1, 256, device=cuda_device)
    with pytest.raises(ValueError, match="state width"):
        ssd.ssd_scan_cuda(x, dt, A, bm, bm, chunk=16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd.ssd_scan_cuda(x, dt, A, bm[..., :16], bm[..., :16], chunk=48)
    xb = torch.zeros(1, 64, 2, 12, device=cuda_device, dtype=torch.bfloat16)
    bb = torch.zeros(1, 64, 1, 16, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ssd.ssd_scan_cuda(xb, dt, A, bb, bb, chunk=16)
    a = torch.zeros(1, 8, 4, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32"):
        rg.rglru_scan_cuda(a, a)
    a = torch.zeros(1, 8, 6, device=cuda_device)   # rows not on 16 bytes
    with pytest.raises(ValueError, match="multiples of 4"):
        rg.rglru_scan_cuda(a, a)
    flat = torch.zeros(1 + 64, device=cuda_device)
    a = flat[1:].view(1, 8, 8)                     # 4 bytes past 16
    assert a.is_contiguous() and a.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="aligned"):
        rg.rglru_scan_cuda(a, a)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("f,p", [(1, 5), (5, 5), (10, 5), (37, 129),
                                 (4096, 1024)])
def test_policy_score_kernels_match_plain(cuda_device, f, p, kind):
    """K1 and K2 against their plain versions on the card, bit-equal, at
    the admission path's shapes and a registry-scale one, energy weights 0,
    0.1 and 0.5."""
    for i, w in enumerate((0.0, 0.1, 0.5)):
        c = make_case(97 * f + p + i, f, p, kind, w)
        w = c["energy_weight"]
        args = [ps.as_tensor(c[k], cuda_device) for k in FUSED_ARGS]
        before = ps.fused_composite_decide_cuda.launches
        got = ps.fused_composite_decide_pallas(*args, w)
        torch.cuda.synchronize()
        assert ps.fused_composite_decide_cuda.launches == before + 1
        want = ps.fused_composite_decide(*args, w)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        m = prebuilt_columns(c)
        cols = [ps.as_tensor(m[k], cuda_device) for k in PREBUILT_ARGS]
        before = ps.composite_decide_cuda.launches
        got2 = ps.composite_decide_pallas(*cols, w)
        torch.cuda.synchronize()
        assert ps.composite_decide_cuda.launches == before + 1
        want2 = ps.composite_decide(*cols, w)
        assert torch.equal(got2[0], want2[0])
        assert torch.equal(got2[1], want2[1])


def _staged_agrees(c, device):
    """K1's staged route on case ``c``: one launch, numpy results
    bit-equal to the kernel on device tensors and to the plain version."""
    w = c["energy_weight"]
    host = [c[k] for k in FUSED_ARGS]
    before = ps.fused_composite_decide_cuda.launches
    choice, ok = ps.fused_composite_decide_staged(*host, w, device=device)
    assert ps.fused_composite_decide_cuda.launches == before + 1
    assert isinstance(choice, np.ndarray) and choice.dtype == np.int32
    assert ok.dtype == np.bool_
    want = ps.fused_composite_decide_cuda(
        *[ps.as_tensor(x, device) for x in host], w)
    plain = ps.fused_composite_decide(*[ps.as_tensor(x, "cpu")
                                        for x in host], w)
    for got, k, p in zip((choice, ok), want, plain):
        np.testing.assert_array_equal(got, k.cpu().numpy())
        np.testing.assert_array_equal(got, p.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("f,p", [(1, 5), (5, 5), (10, 5), (37, 129),
                                 (4096, 1024)])
def test_staged_k1_matches_the_kernel(cuda_device, f, p, kind):
    """K1's staged route (host arrays in its pinned block, read in place
    by the card) against K1 on device tensors and the plain version,
    bit-equal, NaN and +-inf included, energy weights 0, 0.1 and 0.5."""
    for i, w in enumerate((0.0, 0.1, 0.5)):
        _staged_agrees(make_case(97 * f + p + i, f, p, kind, w), cuda_device)


@pytest.mark.cuda
def test_staged_k1_block_grows_and_keeps_deciding(cuda_device):
    ps._STAGING.release()
    _staged_agrees(make_case(1, 1, 5, "random"), cuda_device)
    small = ps._STAGING.buf.size
    assert small == ps.MIN_BLOCK
    _staged_agrees(make_case(2, 4096, 1024, "random"), cuda_device)
    big = ps._STAGING.buf.size
    assert big == ps.block_bytes(ps.staging_layout(4096, 1024)[1]) > small
    _staged_agrees(make_case(3, 1, 5, "nonfinite"), cuda_device)
    assert ps._STAGING.buf.size == big


@pytest.mark.cuda
def test_staged_k1_allocates_no_device_memory(cuda_device):
    c = make_case(4, 5, 5, "random")
    host = [c[k] for k in FUSED_ARGS]
    first = ps.fused_composite_decide_staged(*host, 0.1, device=cuda_device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    launches = ps.fused_composite_decide_cuda.launches
    for _ in range(100):
        got = ps.fused_composite_decide_staged(*host, 0.1,
                                               device=cuda_device)
        assert all((g == f).all() for g, f in zip(got, first))
    assert torch.cuda.memory_allocated(cuda_device) == before
    assert ps.fused_composite_decide_cuda.launches == launches + 100


@pytest.mark.cuda
def test_policy_score_kernels_reject_what_they_do_not_take(cuda_device):
    c = make_case(0, 4, 5, "random")
    args = [ps.as_tensor(c[k], cuda_device) for k in FUSED_ARGS]
    bad = list(args)
    bad[1] = bad[1].long()                       # ewma_n must be int32
    with pytest.raises(ValueError, match="ewma_n"):
        ps.fused_composite_decide_cuda(*bad, 0.1)
    bad = list(args)
    bad[8] = bad[8].cpu()                        # alive on another device
    with pytest.raises(ValueError, match="alive"):
        ps.fused_composite_decide_cuda(*bad, 0.1)
    m = prebuilt_columns(c)
    cols = [ps.as_tensor(m[k], cuda_device) for k in PREBUILT_ARGS]
    with pytest.raises(ValueError, match="exec_s"):
        ps.composite_decide_cuda(cols[0].t(), *cols[1:])


@pytest.mark.cuda
def test_inspector_scenario_three_ways_through_k1(cuda_device):
    """smoke/tiny, a golden scenario of the Inspector, under the numpy
    backend, the torch backend and torch with K1 on the card: byte-identical
    reports, and K1 launched once per torch decision of the K1 run, no other
    kernel at all."""
    from repro_torch.launch.inspector_scenario import run
    counted = (fa.flash_attention_cuda, da.decode_attention_cuda,
               ssd.ssd_scan_cuda, rg.rglru_scan_cuda,
               ps.fused_composite_decide_cuda, ps.composite_decide_cuda)
    reports = {}
    for label, backend, kernel in (("numpy", "numpy", False),
                                   ("torch", "torch", False),
                                   ("torch_k1", "torch", True)):
        before = [fn.launches for fn in counted]
        out = run("smoke/tiny", backend, kernel, cuda_device)
        torch.cuda.synchronize()
        launched = [fn.launches - b for fn, b in zip(counted, before)]
        reports[label] = out["report"].to_json()
        assert (out["torch_decisions"] > 0) == (backend == "torch")
        if kernel:
            assert out["k1_launches"] == out["torch_decisions"]
            assert launched == [0, 0, 0, 0, out["torch_decisions"], 0]
        else:
            assert launched == [0] * len(counted)
    assert reports["torch"] == reports["numpy"]
    assert reports["torch_k1"] == reports["numpy"]


# ---------------------------------------------------------------------------
# The warm-pool forecaster's tick on the card (torch ops, no hand-written
# kernel: the JAX package's tick is jax.jit, not Pallas). Decisions bit-equal
# to the NumPy oracle's.
# ---------------------------------------------------------------------------

def _forecast_stream(seed, rows, ticks):
    """tests/test_autoscale.py's seeded arrival stream and exec seconds."""
    rng = np.random.default_rng(seed)
    bursts = rng.poisson(3.0, size=(ticks, rows)) * \
        (rng.random(size=(ticks, rows)) < 0.25)
    return bursts, rng.uniform(0.02, 0.8, rows)


def _forecast_trajectory(backend, bursts, exec_s):
    from repro_torch.autoscale import PredictivePolicy
    pol = PredictivePolicy(backend=backend)
    pol.resize(bursts.shape[1])
    pol.set_exec(exec_s, 1.0)
    out = []
    for k in range(bursts.shape[0]):
        counts = bursts[k].astype(float)
        desired, ttl = pol.tick(counts, bool(counts.any()))
        out.append((desired.tobytes(), np.asarray(ttl).tobytes()))
    return out, pol.torch_ticks


@pytest.mark.cuda
@pytest.mark.parametrize("seed,rows,ticks", [(3, 9, 300), (5, 4096, 120)])
def test_forecaster_tick_on_card_gives_numpy_decisions(cuda_device, seed,
                                                       rows, ticks):
    from repro_torch.autoscale import forecast
    bursts, exec_s = _forecast_stream(seed, rows, ticks)
    with forecast.forecast_settings("numpy", cuda_device):
        want, _ = _forecast_trajectory("numpy", bursts, exec_s)
    with forecast.forecast_settings("torch", cuda_device):
        got, ticked = _forecast_trajectory("torch", bursts, exec_s)
    assert ticked == int(bursts.any(axis=1).sum()) > 0
    assert got == want


@pytest.mark.cuda
def test_gap_bucket_on_card_exact_at_powers_of_two(cuda_device):
    from repro_torch.kernels import warm_forecast as wf
    idle = np.array([0.0] + [2.0 ** k for k in range(16)]
                    + [2.0 ** k - 1 for k in range(2, 16)]
                    + [3.0, 5.0, 1000.0, 4095.0, 4097.0, 1e7])
    want = np.clip(np.floor(np.log2(np.maximum(idle, 1.0))), 0, 11)
    got = wf.gap_bucket(torch.tensor(idle, dtype=torch.float32,
                                     device=cuda_device), 12)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert got.cpu().numpy().tolist() == want.astype(int).tolist()


@pytest.mark.cuda
def test_forecaster_raises_without_a_card(cuda_device, monkeypatch):
    from repro_torch import device as devmod
    from repro_torch.autoscale import PredictivePolicy, forecast
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with forecast.forecast_settings("torch", None):
        pol = PredictivePolicy()
        pol.resize(3)
        with pytest.raises(devmod.NoCudaDevice, match="CUDA card"):
            pol.tick(np.array([1.0, 0.0, 2.0]), True)
    assert pol.torch_ticks == 0


@pytest.mark.cuda
def test_autoscale_scenario_with_the_forecaster_on_card(cuda_device):
    """autoscale/diurnal-predictive with its forecaster forced to torch on
    the card gives the NumPy forecaster's report, byte for byte; K1 is on
    no path of it (one platform, named by the override)."""
    from repro_torch.launch.inspector_scenario import run
    want = run("autoscale/diurnal-predictive", "numpy", False, cuda_device,
               "numpy")
    before = ps.fused_composite_decide_cuda.launches
    got = run("autoscale/diurnal-predictive", "torch", True, cuda_device,
              "torch")
    assert got["torch_ticks"] > 0 and want["torch_ticks"] == 0
    assert ps.fused_composite_decide_cuda.launches == before
    assert got["report"].to_json() == want["report"].to_json()


# ------------------------------------------------------------- training ----
def _guarded_calls(device):
    """Each kernel entry point on card inputs it takes, with its wrapper:
    (call, float inputs, wrapper)."""
    fq, fk, fv = (torch.from_numpy(x).to(device, torch.bfloat16)
                  for x in card_inputs(*CARD_CASES[0][:6]))
    q, k, v, lens = _decode_case("one_split", "f32", device)
    case = ssd_scan_cases.CASES[0]
    x, dt, A, Bm, Cm = (torch.from_numpy(t).to(device, torch.float32)
                        for t in ssd_scan_cases.inputs(*case))
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(t).to(device, torch.float32)
            for t in (rng.uniform(0.5, 1.0, (1, 64, 32)),
                      rng.normal(size=(1, 64, 32))))
    return {
        "flash_attention": (lambda *t: ops.flash_attention(*t),
                            (fq, fk, fv), fa.flash_attention_cuda),
        "decode_attention": (lambda *t: ops.decode_attention(*t, lens),
                             (q, k, v), da.decode_attention_cuda),
        "ssd_scan": (lambda *t: ops.ssd_scan(*t, chunk=case[-1]),
                     (x, dt, A, Bm, Cm), ssd.ssd_scan_cuda),
        "rglru_scan": (lambda *t: ops.rglru_scan(*t), (a, b),
                       rg.rglru_scan_cuda),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "ssd_scan", "rglru_scan"])
def test_kernel_entry_points_raise_under_autograd_on_the_card(cuda_device,
                                                              name):
    """A CUDA kernel's output has no grad_fn: under autograd, with any
    input that requires grad, the entry point raises before launching, as
    it does on the CPU (tests/test_torch_train.py); without grad mode it
    launches."""
    fn, args, wrapper = _guarded_calls(cuda_device)[name]
    for i in range(len(args)):
        live = [t.clone().requires_grad_(j == i) for j, t in enumerate(args)]
        before = wrapper.launches
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            fn(*live)
        assert wrapper.launches == before
        with torch.no_grad():
            fn(*live)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1


@pytest.mark.cuda
def test_a_reduced_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One f32 step of reduced qwen3-0.6b, two microbatches, on the card
    and on the CPU from the same parameters and batch. Loss 2e-5 rel (a
    TF32 product would move it by ~1e-4); parameters as
    tests/test_torch_train_steps.py holds the port against the JAX package:
    every element within 2e-5 rel + 2.1 lr, 99.9% within 1e-6 rel + 1e-3
    lr (AdamW's step is ill-conditioned where a gradient is near eps)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import model_api as api
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = get_config("qwen3-0.6b").reduced()
    oc = opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    params = tree_map(lambda t: t.float(), api.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    raw = TokenStream(DataConfig(cfg.vocab_size, 128, 4,
                                 mean_doc_len=32)).batch(0)
    out = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(dev), params)
        new, state, m = make_train_step(cfg, oc, 2)(
            p, opt.init_state(oc, api.model_specs(cfg), dev),
            batch_to_device(raw, torch.device(dev)))
        assert int(state["step"]) == 1
        out[str(dev)] = (float(m["loss"]), float(m["lr"]),
                         [t.cpu() for t in tree_leaves(new)])
    (l_cpu, lr, want), (l_card, _, got) = out["cpu"], out["cuda"]
    assert l_card == pytest.approx(l_cpu, rel=2e-5)
    close = total = 0
    for g, w in zip(got, want):
        err = (g - w).abs()
        assert bool((err <= 2e-5 * w.abs() + 2.1 * lr).all())
        close += int((err <= 1e-6 * w.abs() + 1e-3 * lr).sum())
        total += err.numel()
    assert close / total >= 0.999


# ------------------------------------------- a mesh of one rank on the card
@pytest.fixture(scope="module")
def card_mesh():
    """A (1, 1) ("data", "model") mesh over a world of one on the card
    (NCCL, an in-memory store), torn down after the module's tests. One
    card gives one rank; four CPU ranks cover more
    (tests/test_torch_mesh_ranks.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    started = not dist.is_initialized()
    mesh = make_local_mesh(1, device="cuda")
    yield mesh
    if started:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_through_the_local_shard_wrapper(card_mesh, dtype):
    """K3 on DTensors (batch and heads placed on the mesh): one launch, the
    kernel's output on the local shard within the plain version's TOL."""
    from repro_torch import sharding as shd
    mesh = card_mesh
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 128, h, 64, generator=g, device="cuda").to(
        TORCH[dtype]) for h in (4, 2, 2))
    sh = shd.named_sharding(mesh, q.shape, ("batch", None, "heads", None))
    kv_sh = shd.named_sharding(mesh, k.shape, ("batch", None, "heads", None))
    fa.flash_attention_cuda.launches = 0
    with shd.use_mesh(mesh):
        out = ops.flash_attention(shd.distribute(q, sh),
                                  shd.distribute(k, kv_sh),
                                  shd.distribute(v, kv_sh))
    assert shd.is_dtensor(out) and fa.flash_attention_cuda.launches == 1
    want = fa.flash_attention_plain(q, k, v, causal=True)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.to_local().float(), want.float(),
                               atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_shmap_flash_decode_on_the_card_matches_plain_decode(card_mesh):
    """Reduced qwen3 in bf16: prefill, then three split-K decode steps on
    the mesh, fed the meshless greedy decode's tokens, against it: logits
    within the JAX package's 5e-2 for its two decode routes, the same
    greedy choice wherever the top two logits are more than 0.1 apart."""
    from repro_torch import sharding as shd
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_api as api
    from repro_torch.models import params as pm
    mesh = card_mesh
    cfg = get_config("qwen3-0.6b").reduced().replace(
        decode_impl="shmap_flash")
    params = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda")
    toks = torch.randint(1, cfg.vocab_size, (4, 16), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    runs, fed = [], [toks[:, -1:]]
    with torch.inference_mode():
        for placed in (False, True):
            _, cache = api.prefill(cfg, params, {"tokens": toks}, 16)
            p = params
            if placed:
                cache = pm.distribute(cache, api.cache_shardings(
                    cfg, mesh, 4, 16))
                p = pm.distribute(params, api.param_shardings(cfg, mesh))
            logits = []
            with shd.use_mesh(mesh if placed else None):
                for i in range(3):
                    lg, cache = api.decode_step(cfg, p, cache,
                                                {"token": fed[i]})
                    lg = lg.full_tensor() if placed else lg
                    logits.append(lg.float())
                    if not placed:
                        fed.append(lg[:, -1].argmax(-1)[:, None])
            runs.append(torch.stack(logits))
    torch.testing.assert_close(runs[1], runs[0], atol=5e-2, rtol=5e-2)
    top2 = runs[0].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 0.1
    assert torch.equal(runs[1].argmax(-1)[clear], runs[0].argmax(-1)[clear])


@pytest.mark.cuda
def test_zero_placed_train_step_on_the_card_matches_meshless(card_mesh):
    """Reduced qwen3 in f32, one train step with the parameters placed by
    ``param_shardings`` and AdamW's state by ``state_shardings`` (the ZeRO
    axis) against the meshless step, each leaf in its declared placement.
    On a world of one the local ops are the meshless ones, but on the
    card the meshless step itself does not always repeat bit for bit
    (``launch/mesh_parity.py``: its first step and later ones take two bit
    patterns, and the mesh step equals one of them): the f32 train tests'
    tolerance (tests/train_cases.py ``check_params``: loss 2e-5
    rel; parameters 2e-5 rel + 2.1 lr, 99.9% within 1e-6 rel + 1e-3 lr; m
    and v within 1e-4 of their leaf's largest entry)."""
    from repro_torch import sharding as shd
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_api as api
    from repro_torch.models import params as pm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    mesh = card_mesh
    cfg = get_config("qwen3-0.6b").reduced()
    oc = opt.OptConfig()
    specs = api.model_specs(cfg)
    shape = InputShape("t", 32, 4, "train")
    params = pm.tree_map(lambda t: t.float(), api.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"))
    batch = api.make_batch(cfg, shape, np.random.default_rng(0),
                           device="cuda")
    step = make_train_step(cfg, oc)
    p0, s0, m0 = step(params, opt.init_state(oc, specs, "cuda"), batch)
    p_sh, s_sh = api.param_shardings(cfg, mesh), opt.state_shardings(
        oc, specs, mesh)
    with shd.use_mesh(mesh):
        p1, s1, m1 = step(pm.distribute(params, p_sh),
                          pm.distribute(opt.init_state(oc, specs, "cuda"),
                                        s_sh),
                          pm.distribute(batch, api.batch_shardings(
                              cfg, mesh, shape)))
    assert float(m1["loss"].full_tensor()) == pytest.approx(
        float(m0["loss"]), rel=2e-5)
    lr = float(m0["lr"])
    close = total = 0
    for got, want, sh in zip(pm.tree_leaves(p1), pm.tree_leaves(p0),
                             pm.tree_leaves(p_sh)):
        assert tuple(got.placements) == sh.placements
        err = (got.to_local() - want).abs()
        assert bool((err <= 2e-5 * want.abs() + 2.1 * lr).all())
        close += int((err <= 1e-6 * want.abs() + 1e-3 * lr).sum())
        total += err.numel()
    assert close / total >= 0.999
    for got, want, sh in zip(pm.tree_leaves(s1), pm.tree_leaves(s0),
                             pm.tree_leaves(s_sh)):
        assert tuple(got.placements) == sh.placements
        err = float((got.to_local().float() - want.float()).abs().max())
        assert err <= 1e-4 * max(float(want.float().abs().max()), 1e-30)
