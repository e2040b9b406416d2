"""The port's split-K decode attention (plain PyTorch version on CPU tensors)
against the JAX package's Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and its oracle, on the same numpy-seeded
inputs, and on the KV caches that the port's own prefill builds.

Tolerances (atol, rtol):

* f32 2e-5 and 2e-5, that of tests/test_kernels.py.
* bf16 2e-4 and 2**-7: both sides compute in f32 and round the output once
  to bf16, so they differ by at most one bf16 step (2**-7 of the value);
  2e-4 stays well under a typical |out| (about 0.06 at these 0.3-scale
  inputs), where tests/test_kernels.py's 2e-2 would pass a wrong kernel.
* against ``layers.attend`` (what decode runs) on a real cache, per element
  |K4 - attend| <= 2**-7 * (|attend| + sum_j p_j |v_j|), the last term being
  the oracle applied to |v| in f32. ``attend`` rounds its probabilities to
  bf16 before the product with v (``models/layers.py``), which moves the
  output by at most 2**-9 * sum_j p_j |v_j|, and each side rounds its output
  once (2**-7 of the value between them). At the serving shapes (B=4,
  T=1152, H=16, KH=8, D=128 and KH=1, D=256; ragged lengths; normal inputs
  of scale 0.3, 1 and 3: ``test_attend_limit_at_serving_shapes``) the error
  reaches at most 0.50 of this limit on the CPU: one bf16 step of the
  output, where the two roundings fall apart.

The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against the plain version there.
"""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from decode_attention_cases import CASES  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.kernels import decode_attention as jdec  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import model_api as japi  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model_api as tapi  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = {"f32": (2e-5, 2e-5), "bf16": (2e-4, 2 ** -7)}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed, b, t, h, kh, d, lengths, dtype):
    """The same values in both frameworks: numpy draws, rounded once to the
    working dtype and carried across through float32."""
    rng = np.random.default_rng(seed)
    outs = []
    for shape in [(b, h, d), (b, t, kh, d), (b, t, kh, d)]:
        x = jnp.asarray(rng.normal(size=shape) * 0.3, JNP[dtype])
        outs.append((x, torch.from_numpy(np.array(x, np.float32)).to(
            TORCH[dtype])))
    lens = (rng.integers(1, t + 1, b) if lengths is None
            else np.array(lengths)).astype(np.int32)
    outs.append((jnp.asarray(lens), torch.from_numpy(lens)))
    return outs


def _close(got, want, tol):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    atol, rtol = tol
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_attention_matches_pallas(dtype, case):
    b, t, h, kh, d, splits, kv_block, lengths = CASES[case]
    (jq, q), (jk, k), (jv, v), (jl, lens) = _inputs(
        t + h, b, t, h, kh, d, lengths, dtype)
    out = ops.decode_attention(q, k, v, lens, splits=splits,
                               kv_block=kv_block)
    assert out.dtype == TORCH[dtype] and out.shape == (b, h, d)
    assert torch.isfinite(out).all()
    _close(out, jops.decode_attention(jq, jk, jv, jl, splits=splits,
                                      kv_block=kv_block), TOL[dtype])
    _close(out, jref.decode_attention_ref(jq, jk, jv, jl), TOL[dtype])
    _close(out, ref.decode_attention_ref(q, k, v, lens), TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_attention_ref_matches_jax_ref(dtype, case):
    b, t, h, kh, d, _, _, lengths = CASES[case]
    (jq, q), (jk, k), (jv, v), (jl, lens) = _inputs(
        t + h + 1, b, t, h, kh, d, lengths, dtype)
    out = ref.decode_attention_ref(q, k, v, lens)
    assert out.dtype == TORCH[dtype] and out.shape == (b, h, d)
    _close(out, jref.decode_attention_ref(jq, jk, jv, jl), TOL[dtype])


def test_length_zero_row_is_the_mean_of_v():
    """The finite mask weighs every key alike when none is valid."""
    (_, q), (_, k), (_, v), _ = _inputs(3, 2, 256, 4, 2, 32, [0, 0], "f32")
    out = ops.decode_attention(q, k, v, torch.zeros(2, dtype=torch.int32),
                               splits=4, kv_block=64)
    mean = v.mean(1).repeat_interleave(2, dim=1)        # (B,H,D)
    _close(out, mean, TOL["f32"])


def _jax_accepts(t, splits, kv_block):
    q = jax.ShapeDtypeStruct((1, 1, 8), jnp.float32)
    kv = jax.ShapeDtypeStruct((1, t, 1, 8), jnp.float32)
    lens = jax.ShapeDtypeStruct((1,), jnp.int32)
    try:
        jax.eval_shape(functools.partial(
            jdec.decode_attention, splits=splits, kv_block=kv_block,
            interpret=True), q, kv, kv, lens)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("splits,kv_block", [(4, 128), (8, 64), (3, 128),
                                             (1, 128), (2, 50)])
@pytest.mark.parametrize("t", [100, 1000, 1029, 1152])
def test_split_rule_accepts_what_the_reference_accepts(t, splits, kv_block):
    """T=100 passes with splits 1, T=1152 (the serving capacity) with
    splits 3, T=1000 and T=1029 fail under the defaults. Both routes apply
    the rule before anything else: on CPU tensors the CUDA wrapper then
    fails on the device check, not on the shape."""
    want = _jax_accepts(t, splits, kv_block)
    q, kv = torch.zeros(1, 2, 32), torch.zeros(1, t, 1, 32)
    lens = torch.full((1,), t, dtype=torch.int32)
    if want:
        s, blk = da.split_rule(t, splits, kv_block)
        assert 1 <= s <= splits and blk <= kv_block
        assert t % s == 0 and (t // s) % blk == 0
        assert ops.decode_attention(q, kv, kv, lens, splits=splits,
                                    kv_block=kv_block).shape == q.shape
        with pytest.raises(ValueError, match="CUDA tensors"):
            da.decode_attention_cuda(q, kv, kv, lens, splits=splits,
                                     kv_block=kv_block)
    else:
        with pytest.raises(ValueError, match=f"T={t}"):
            da.split_rule(t, splits, kv_block)
        for fn in (ops.decode_attention, da.decode_attention_cuda):
            with pytest.raises(ValueError, match=f"T={t}"):
                fn(q, kv, kv, lens, splits=splits, kv_block=kv_block)


def test_split_rule_lowers_as_the_reference():
    assert da.split_rule(1152, 4, 128) == (3, 128)
    assert da.split_rule(100, 4, 128) == (1, 100)
    assert da.split_rule(512, 8, 64) == (8, 64)
    assert da.split_rule(256, 4, 128) == (2, 128)


def test_shapes_and_devices_are_checked():
    q, kv = torch.zeros(2, 4, 32), torch.zeros(2, 128, 2, 32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="lengths"):
        ops.decode_attention(q, kv, kv, lens[:1])
    with pytest.raises(ValueError, match="head grouping"):
        ops.decode_attention(q[:, :3], kv, kv, lens)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.decode_attention(q.to("meta"), kv.to("meta"), kv.to("meta"),
                             lens.to("meta"))


def test_kernel_splits_cover_the_cache():
    """The splits of one (batch row, kv head) are one cluster: a power of
    two, at most the cluster the card can co-schedule, each split holding
    keys."""
    h100 = 2 * 132                         # two blocks per SM, 132 SMs
    for b, kh, t in [(4, 8, 1152), (4, 1, 1152), (1, 1, 100), (64, 8, 4096),
                     (2, 2, 32)]:
        for cap in (16, 8, 2):
            n, split_len = da.kernel_splits(b, kh, t, h100, cap)
            assert n & (n - 1) == 0 and 1 <= n <= cap
            assert (n - 1) * split_len < t <= n * split_len
    assert da.kernel_splits(4, 8, 1152, h100) == (8, 144)
    assert da.kernel_splits(4, 1, 1152, h100) == (16, 72)
    assert da.kernel_splits(4, 1, 1152, h100, 8) == (8, 144)
    assert da.kernel_splits(64, 8, 4096, h100) == (1, 4096)


# ---------------------------------------------------------------------------
# Real caches: what the port's prefill builds
# ---------------------------------------------------------------------------


def _attend_limit(q, kc, vc, lens, att):
    """2**-7 * (|attend| + sum_j p_j |v_j|); see the module docstring."""
    pv = ref.decode_attention_ref(q.float(), kc.float(), vc.float().abs(),
                                  lens)
    return 2 ** -7 * (att.float().abs() + pv)


@pytest.mark.parametrize("scale", [0.3, 1.0, 3.0])
@pytest.mark.parametrize("kh,d,lengths", [
    (8, 128, [64, 300, 700, 1000]),       # qwen3-0.6b's cache
    (1, 256, [1000, 1000, 1000, 1000]),   # recurrentgemma-9b's local cache
])
def test_attend_limit_at_serving_shapes(kh, d, lengths, scale):
    """K4 against ``layers.attend`` on bf16 caches of the serving shape,
    within the limit of the module docstring."""
    rng = np.random.default_rng(int(10 * scale) + kh)
    q, k, v = (torch.from_numpy(rng.normal(size=shape) * scale).to(
        torch.bfloat16) for shape in [(4, 16, d), (4, 1152, kh, d),
                                      (4, 1152, kh, d)])
    lens = torch.tensor(lengths, dtype=torch.int32)
    k_pos = torch.arange(1152)[None, :].expand(4, -1)
    k_pos = torch.where(k_pos < lens[:, None], k_pos, -1)
    out = ops.decode_attention(q, k, v, lens)
    att = layers.attend(q[:, None], k, v, lens[:, None], k_pos)[:, 0]
    err = (out.float() - att.float()).abs()
    assert bool((err <= _attend_limit(q, k, v, lens, att)).all())


def _real_cache_parity(arch, layers_with_kv, batch, ctx, window):
    jcfg = jreg.get_config(arch).reduced()
    tcfg = treg.get_config(arch).reduced()
    raw = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, raw),
                           device="cpu")
    with torch.inference_mode():
        _, cache = tapi.prefill(tcfg, tp, batch, ctx)
    pos, k_pos = cache["pos"], cache["k_pos"]
    b, t = k_pos.shape
    assert cache["k"].shape[:3] == (layers_with_kv, b, t)
    rng = np.random.default_rng(11)
    for i in range(layers_with_kv):
        kc, vc = cache["k"][i], cache["v"][i]
        assert kc.dtype == torch.bfloat16 and kc.is_contiguous()
        q = torch.from_numpy(rng.normal(
            size=(b, tcfg.n_heads, tcfg.head_dim))).to(torch.bfloat16)
        out = ops.decode_attention(q, kc, vc, pos)
        assert torch.isfinite(out).all()
        att = layers.attend(q[:, None], kc, vc, pos[:, None], k_pos,
                            causal=True, window=window)[:, 0]
        err = (out.float() - att.float()).abs()
        assert bool((err <= _attend_limit(q, kc, vc, pos, att)).all()), (
            f"layer {i}: K4 is {float(err.max())} from attend")
        as_jax = [jnp.asarray(np.array(x.float(), np.float32), jnp.bfloat16)
                  for x in (q, kc, vc)]
        _close(out, jops.decode_attention(*as_jax, jnp.asarray(pos.numpy())),
               TOL["bf16"])


def test_real_dense_cache_matches_attend_and_pallas():
    """Reduced qwen3-0.6b, ragged right-padded prompts at context 128: the
    cache holds T=256 slots, so the reference splits it in 2."""
    rng = np.random.default_rng(5)
    lens = np.array([1, 37, 100, 128], np.int32)
    toks = rng.integers(1, 512, (4, 128))
    _real_cache_parity("qwen3-0.6b", 2,
                       {"tokens": torch.from_numpy(toks),
                        "prompt_lens": torch.from_numpy(lens)}, 128, None)


def test_real_hybrid_local_cache_matches_attend_and_pallas():
    """Reduced recurrentgemma-9b: its local-attention cache (window 32)
    after a 20-token prefill, so the ring has not wrapped."""
    cfg = treg.get_config("recurrentgemma-9b").reduced()
    toks = np.random.default_rng(6).integers(1, 512, (3, 20))
    _real_cache_parity("recurrentgemma-9b", trg.n_super(cfg),
                       {"tokens": torch.from_numpy(toks)}, 64,
                       cfg.local_window)


# ---------------------------------------------------------------------------
# The bf16 kernel's tensor-core route (G > 8), emulated on the CPU
# ---------------------------------------------------------------------------


def _mma_rounding(q, k, v, lengths, n_splits, split_len, split_p=True):
    """K4's route for bf16 groups of more than 8, rounded where it rounds:
    S = q . k^T of the bf16 values in f32 (exact products), scaled after;
    f32 online softmax over 32-key tiles of each split, keys past the
    split's end at -inf, past the length at -1e30, tiles at and past a
    row's length skipped unless the length is 0; P . V with p handed over
    as bf16 hi + lo (``split_p``) or as bf16 alone, sums in f32, l over the
    unrounded p; the splits combined by their global max; the output
    rounded once to bf16."""
    b, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qr = q.float().reshape(b, kh, g, d)
    kr, vr = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # (B,KH,T,D)
    lens = lengths.long()
    parts = []
    for s in range(n_splits):
        s0, s1 = s * split_len, min((s + 1) * split_len, t)
        end = torch.where(lens > 0, lens.clamp(max=s1), torch.tensor(s1))
        m = torch.full((b, kh, g, 1), da.NEG_INF)
        l = torch.zeros(b, kh, g, 1)
        acc = torch.zeros(b, kh, g, d)
        for k0 in range(s0, s1, da.KEY_TILE):
            kp = torch.arange(k0, k0 + da.KEY_TILE)
            kt = torch.zeros(b, kh, da.KEY_TILE, d)
            vt = torch.zeros_like(kt)
            n = min(k0 + da.KEY_TILE, s1) - k0
            kt[:, :, :n], vt[:, :, :n] = kr[:, :, k0:k0 + n], vr[:, :, k0:k0 + n]
            sc = (qr @ kt.transpose(-1, -2)) * d ** -0.5
            sc = torch.where(kp >= lens[:, None, None, None], da.NEG_INF, sc)
            sc = torch.where(kp >= s1, float("-inf"), sc)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            p_hi = p.bfloat16().float()
            pv = p_hi @ vt
            if split_p:
                pv = pv + (p - p_hi).bfloat16().float() @ vt
            on = (k0 < end)[:, None, None, None]
            l = torch.where(on, l * alpha + p.sum(-1, keepdim=True), l)
            acc = torch.where(on, acc * alpha + pv, acc)
            m = torch.where(on, m_new, m)
        parts.append((m, l, acc))
    m_g = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - m_g) for m, _, _ in parts]
    l_g = sum(l * wi for (_, l, _), wi in zip(parts, w))
    acc_g = sum(a * wi for (_, _, a), wi in zip(parts, w))
    return (acc_g / l_g.clamp_min(1e-30)).reshape(b, h, d).bfloat16()


MMA_CASES = [c for c in CASES
             if CASES[c][2] // CASES[c][3] >= da.MMA_MIN_GROUP]


def _of_card_limit(got, want):
    atol, rtol = TOL["bf16"]
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _mma_case(name):
    b, t, h, kh, d, splits, kv_block, lengths = CASES[name]
    (jq, q), (jk, k), (jv, v), (jl, lens) = _inputs(
        t + h, b, t, h, kh, d, lengths, "bf16")
    # the split the card takes: two blocks per SM of 132, clusters of <= 16
    n, split_len = da.kernel_splits(b, kh, t, 2 * 132, da.MAX_SPLITS)
    return (q, k, v, lens, n, split_len, splits, kv_block), (jq, jk, jv, jl)


def test_tensor_core_cases_exist():
    assert {"g12", "g16", "g16_d256", "g24", "g64",
            "g48_d256"} <= set(MMA_CASES)


@pytest.mark.parametrize("name", MMA_CASES)
def test_mma_rounding_matches_plain_pallas_and_oracle(name):
    """With p split, the tensor-core route lands within the card's bf16
    tolerance of the plain version (0.04-0.28 of it on these cases), of
    the Pallas kernel (interpret mode) and of the oracle on the same bf16
    values."""
    (q, k, v, lens, n, split_len, splits, kv_block), j = _mma_case(name)
    got = _mma_rounding(q, k, v, lens, n, split_len)
    assert torch.isfinite(got.float()).all()
    want = da.decode_attention_plain(q, k, v, lens, splits=splits,
                                     kv_block=kv_block)
    assert _of_card_limit(got, want) <= 0.5
    _close(got, jops.decode_attention(*j, splits=splits, kv_block=kv_block),
           TOL["bf16"])
    _close(got, jref.decode_attention_ref(*j), TOL["bf16"])


def _serving_d256(scale):
    """recurrentgemma-9b's local cache (B=4, T=1152, G=16, D=256) at its
    ragged check lengths, 0 among them, normal inputs of ``scale``."""
    from decode_attention_cases import SERVING, SERVING_LENGTHS
    b, t, h, kh, d = SERVING["d256"]
    rng = np.random.default_rng(int(10 * scale))
    q, k, v = (torch.from_numpy(rng.normal(size=shape) * scale).bfloat16()
               for shape in [(b, h, d), (b, t, kh, d), (b, t, kh, d)])
    lens = torch.tensor(SERVING_LENGTHS["d256"], dtype=torch.int32)
    n, split_len = da.kernel_splits(b, kh, t, 2 * 132, da.MAX_SPLITS)
    return (q, k, v, lens, n, split_len), da.decode_attention_plain(
        q, k, v, lens)


@pytest.mark.parametrize("scale", [0.3, 1.0, 3.0])
def test_mma_rounding_at_the_serving_cache(scale):
    """With p split: 0.0006-0.36 of the card's limit at scales 3, 0.3, 1."""
    args, want = _serving_d256(scale)
    assert _of_card_limit(_mma_rounding(*args), want) <= 0.5


def test_p_rounded_once_breaks_the_card_tolerance():
    """Why p is split: rounded once to bf16 it lands 3.6x the card's limit
    from the plain version at the serving cache with inputs of scale 3
    (0.38-0.98x at scales 0.3 and 1, 0.55-0.83x on the cases above)."""
    args, want = _serving_d256(3.0)
    assert _of_card_limit(_mma_rounding(*args, split_p=False), want) > 1.0
