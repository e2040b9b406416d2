"""The port's model families against the JAX package's: the dense
transformer at the reduced qwen3-0.6b config, Mamba-2 at the reduced
mamba2-2.7b config, and the RG-LRU hybrid at the reduced recurrentgemma-9b
config (one super-block, no tail) and at ``num_layers=5`` (one super-block
and the two tail blocks), with the JAX package's own initialised parameters
(``init_params(cfg, PRNGKey(0))``) carried across by ``params_from_numpy``.

Each case runs with ``use_pallas`` off and on (on: the JAX side runs the
Pallas kernel in interpret mode, the port the kernel's plain version on the
CPU), in f32 parameters for a tight bound and in bf16 parameters at the bf16
tolerance:

* f32: 2e-5 abs/rel; only summation order differs. Where an f32 value is
  stored in the bf16 cache (uniform prefill), the two roundings may land on
  neighbouring bf16 values: 2**-7 rel; decode logits read through that cache
  get 1e-3 abs.
* bf16: both frameworks round every op to bf16 (2**-8 rel), at different
  places (matmul accumulation, silu, the probability cast), across 2 layers
  and the head: 2**-5 of the largest reference value, abs.

The recurrent families' cache leaves are compared by the JAX leaf's dtype:
f32 states at the f32 tolerance, bf16 leaves (the hybrid's conv buffers and
k/v) as values stored in a bf16 cache, int leaves exactly.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import model_api as japi  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import model_api as tapi  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import params as tpm  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "qwen3-0.6b"
CTX = 192
SEQ = 128             # > attn_q_chunk (64) of the reduced config
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jax_params():
    return japi.init_params(jreg.get_config(ARCH).reduced(),
                            jax.random.PRNGKey(0))


def _setup(jax_params, dtype, use_pallas):
    jdt, tdt = DTYPES[dtype]
    jcfg = jreg.get_config(ARCH).reduced().replace(use_pallas=use_pallas)
    tcfg = treg.get_config(ARCH).reduced().replace(use_pallas=use_pallas)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jdt), jax_params)
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                        jax_params),
                           dtype=tdt, device="cpu")
    return jcfg, jp, tcfg, tp


def _close(got, want, dtype, kind="logits"):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "bf16":
        tol = dict(atol=2 ** -5 * float(np.abs(want).max()), rtol=0)
    elif kind == "bf16_cache":
        tol = dict(atol=1e-6, rtol=2 ** -7)
    elif kind == "via_bf16_cache":
        tol = dict(atol=1e-3, rtol=0)
    else:
        tol = dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, want, **tol)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(1, 512, shape)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_configs_match_field_for_field(arch):
    j, t = jreg.get_config(arch), treg.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert j.n_params() == t.n_params()


def test_param_tree_matches_leaf_for_leaf(jax_params):
    cfg = treg.get_config(ARCH).reduced()
    specs = tapi.model_specs(cfg)
    jleaves = jax.tree_util.tree_leaves(jax_params)
    tleaves = tpm.tree_leaves(specs)
    assert [tuple(a.shape) for a in jleaves] == [s.shape for s in tleaves]
    assert tapi.param_count(cfg) == japi.param_count(
        jreg.get_config(ARCH).reduced())
    # the port's own init: same tree, its initialisers' scales
    p = tapi.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert p["layers"]["ln1"].abs().max() == 0
    emb_std = float(p["embed"].float().std())
    assert abs(emb_std - 0.7 / np.sqrt(cfg.vocab_size)) < 0.1 * emb_std


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_logits(jax_params, dtype, use_pallas):
    jcfg, jp, tcfg, tp = _setup(jax_params, dtype, use_pallas)
    toks = _tokens(0, (2, SEQ))
    jh, _, _ = jtfm.forward_hidden(
        jcfg, jp, jtfm.embed_inputs(jcfg, jp, {"tokens": jnp.asarray(toks)}))
    th, _, _ = ttfm.forward_hidden(
        tcfg, tp, ttfm.embed_inputs(tcfg, tp,
                                    {"tokens": torch.from_numpy(toks)}))
    _close(ttfm.logits_fn(tcfg, tp, th), jtfm.logits_fn(jcfg, jp, jh), dtype)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_uniform_prefill_then_decode(jax_params, dtype, use_pallas):
    jcfg, jp, tcfg, tp = _setup(jax_params, dtype, use_pallas)
    toks = _tokens(1, (2, SEQ))
    jlog, jc = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, CTX)
    tlog, tc = tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                            CTX)
    _close(tlog, jlog, dtype)
    assert tc["k"].dtype == torch.bfloat16        # as the JAX cache
    _close(tc["k"], jc["k"], dtype, "bf16_cache")
    _close(tc["v"], jc["v"], dtype, "bf16_cache")
    np.testing.assert_array_equal(tc["k_pos"].numpy(), np.asarray(jc["k_pos"]))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for step in range(3):
        tok = _tokens(10 + step, (2, 1))
        jlog, jc = japi.decode_step(jcfg, jp, jc, {"token": jnp.asarray(tok)})
        tlog, tc = tapi.decode_step(tcfg, tp, tc,
                                    {"token": torch.from_numpy(tok)})
        _close(tlog, jlog, dtype, "via_bf16_cache")
        np.testing.assert_array_equal(tc["k_pos"].numpy(),
                                      np.asarray(jc["k_pos"]))
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ragged_prefill_then_decode(jax_params, dtype, use_pallas):
    jcfg, jp, tcfg, tp = _setup(jax_params, dtype, use_pallas)
    toks = _tokens(2, (2, SEQ))
    lens = np.array([50, SEQ], np.int32)
    jlog, jc = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks),
                                       "prompt_lens": jnp.asarray(lens)}, CTX)
    tlog, tc = tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                       "prompt_lens": torch.from_numpy(lens)},
                            CTX)
    _close(tlog, jlog, dtype)
    _close(tc["k"], jc["k"], dtype)
    _close(tc["v"], jc["v"], dtype)
    np.testing.assert_array_equal(tc["k_pos"].numpy(), np.asarray(jc["k_pos"]))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for step in range(3):
        tok = _tokens(20 + step, (2, 1))
        jlog, jc = japi.decode_step(jcfg, jp, jc, {"token": jnp.asarray(tok)})
        tlog, tc = tapi.decode_step(tcfg, tp, tc,
                                    {"token": torch.from_numpy(tok)})
        _close(tlog, jlog, dtype)


# ---------------------------------------------------------------------------
# Mamba-2 and the RG-LRU hybrid
# ---------------------------------------------------------------------------

RECURRENT = {"mamba2": ("mamba2-2.7b", None),
             "rglru": ("recurrentgemma-9b", None),
             "rglru-5": ("recurrentgemma-9b", 5)}
REC_SEQ = 40          # not a multiple of the reduced mamba2's chunk (16),
REC_CTX = 64          # longer than the reduced hybrid's window (32)


def _rec_cfgs(name, use_pallas=False):
    arch, layers = RECURRENT[name]
    jcfg, tcfg = jreg.get_config(arch).reduced(), treg.get_config(
        arch).reduced()
    if layers is not None:
        jcfg, tcfg = (c.replace(num_layers=layers) for c in (jcfg, tcfg))
    return (jcfg.replace(use_pallas=use_pallas),
            tcfg.replace(use_pallas=use_pallas))


@pytest.fixture(scope="module")
def rec_params():
    out = {}
    for name in RECURRENT:
        jcfg, _ = _rec_cfgs(name)
        out[name] = japi.init_params(jcfg, jax.random.PRNGKey(0))
    return out


def _rec_setup(rec_params, name, dtype, use_pallas):
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = _rec_cfgs(name, use_pallas)
    raw = rec_params[name]
    jp = jax.tree_util.tree_map(lambda a: a.astype(jdt), raw)
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, raw),
                           dtype=tdt, device="cpu")
    return jcfg, jp, tcfg, tp


def _close_cache(got, want, dtype, decode=False):
    """Leaf by leaf, by the JAX leaf's dtype (see the module docstring)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_cache(got[k], want[k], dtype, decode)
        return
    jdt = str(want.dtype)
    assert {torch.float32: "float32", torch.bfloat16: "bfloat16",
            torch.int32: "int32"}[got.dtype] == jdt
    if jdt == "int32":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif jdt == "bfloat16":
        _close(got, want, dtype, "bf16_cache")
    else:
        _close(got, want, dtype, "via_bf16_cache" if decode else "logits")


def _jax_forward(jcfg, jp, toks):
    emb = jnp.take(jp["embed"], jnp.asarray(toks), axis=0)
    mod = jm2 if jcfg.family == "ssm" else jrg
    return mod.forward_hidden(jcfg, jp, emb)[0]


@pytest.mark.parametrize("name", list(RECURRENT))
def test_recurrent_param_tree_matches_leaf_for_leaf(rec_params, name):
    jcfg, tcfg = _rec_cfgs(name)
    jleaves = jax.tree_util.tree_leaves(rec_params[name])
    tleaves = tpm.tree_leaves(tapi.model_specs(tcfg))
    assert [tuple(a.shape) for a in jleaves] == [s.shape for s in tleaves]
    assert tapi.param_count(tcfg) == japi.param_count(jcfg)
    # the port's uniform initialisers land in the JAX package's ranges
    p = tapi.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    if tcfg.family == "ssm":
        A = torch.exp(p["layers"]["A_log"].float())
        dt = torch.nn.functional.softplus(p["layers"]["dt_bias"].float())
        assert 0.99 <= float(A.min()) and float(A.max()) <= 16.1
        assert 0.99e-3 <= float(dt.min()) and float(dt.max()) <= 0.101
    else:
        a = torch.exp(-8.0 * torch.nn.functional.softplus(
            p["supers"]["rec1"]["lam"].float()))
        assert 0.899 <= float(a.min()) and float(a.max()) <= 0.9995


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(RECURRENT))
def test_recurrent_forward_logits(rec_params, name, dtype, use_pallas):
    jcfg, jp, tcfg, tp = _rec_setup(rec_params, name, dtype, use_pallas)
    toks = _tokens(3, (2, REC_SEQ))
    jh = _jax_forward(jcfg, jp, toks)
    mod = tm2 if tcfg.family == "ssm" else trg
    th, _, _ = mod.forward_hidden(tcfg, tp,
                                  tp["embed"][torch.from_numpy(toks)])
    _close(ttfm.logits_fn(tcfg, tp, th), jtfm.logits_fn(jcfg, jp, jh), dtype)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(RECURRENT))
def test_recurrent_prefill_then_decode(rec_params, name, dtype, use_pallas):
    """Prefill logits and every cache leaf, then three decode steps."""
    jcfg, jp, tcfg, tp = _rec_setup(rec_params, name, dtype, use_pallas)
    toks = _tokens(4, (2, REC_SEQ))
    jlog, jc = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                            REC_CTX)
    tlog, tc = tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                            REC_CTX)
    _close(tlog, jlog, dtype)
    _close_cache(tc, jc, dtype)
    for step in range(3):
        tok = _tokens(30 + step, (2, 1))
        jlog, jc = japi.decode_step(jcfg, jp, jc, {"token": jnp.asarray(tok)})
        tlog, tc = tapi.decode_step(tcfg, tp, tc,
                                    {"token": torch.from_numpy(tok)})
        _close(tlog, jlog, dtype, "via_bf16_cache")
        _close_cache(tc, jc, dtype, decode=True)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", list(RECURRENT))
def test_recurrent_decode_matches_full_forward(rec_params, name, use_pallas):
    """Twin of tests/test_models.py's test_decode_matches_full_forward, in
    the port: greedy decode after prefill == argmax of a full re-forward
    (bf16 parameters, as there)."""
    _, _, tcfg, tp = _rec_setup(rec_params, name, "bf16", use_pallas)
    toks = np.random.default_rng(1).integers(1, tcfg.vocab_size, (1, 16))
    logits, cache = tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                 48)
    seq = list(toks[0])
    mod = tm2 if tcfg.family == "ssm" else trg
    for step in range(3):
        nxt = int(torch.argmax(logits[0, -1]))
        h, _, _ = mod.forward_hidden(tcfg, tp,
                                     tp["embed"][torch.tensor([seq])])
        ref_logits = ttfm.logits_fn(tcfg, tp, h[:, -1:, :])
        assert int(torch.argmax(ref_logits[0, -1])) == nxt, \
            f"{name}: decode diverges at step {step}"
        seq.append(nxt)
        logits, cache = tapi.decode_step(tcfg, tp, cache,
                                         {"token": torch.tensor([[nxt]])})


def test_mesh_bodies_take_the_unsharded_branch_without_a_mesh(jax_params,
                                                               monkeypatch):
    """``decode_impl="shmap_flash"`` takes the split-K body only under a
    mesh with a "model" axis (the JAX package's condition): without one the
    decode is the plain decode, bit for bit, and the body is never called;
    under a mesh the body runs (tests/test_torch_mesh_ranks.py)."""
    _, _, tcfg, tp = _setup(jax_params, "f32", False)
    called = []
    monkeypatch.setattr(ttfm, "_flash_decode_shmap",
                        lambda *a, **k: called.append(1))
    toks = torch.from_numpy(_tokens(1, (2, SEQ)))
    outs = []
    for impl in ("gspmd", "shmap_flash"):
        cfg = tcfg.replace(decode_impl=impl)
        _, cache = tapi.prefill(cfg, tp, {"tokens": toks}, CTX)
        logits, cache = tapi.decode_step(
            cfg, tp, cache, {"token": torch.from_numpy(_tokens(10, (2, 1)))})
        outs.append((logits, cache["k"]))
    assert not called
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b",
                                  "phi-3-vision-4.2b", "whisper-small"])
def test_params_from_numpy_carries_every_family(arch):
    """The MoE, VLM and encoder-decoder trees cross leaf for leaf, bf16
    values bit for bit, and a tree with a leaf missing is refused."""
    jcfg = jreg.get_config(arch).reduced()
    tcfg = treg.get_config(arch).reduced()
    raw = jax.tree_util.tree_map(np.asarray,
                                 japi.init_params(jcfg,
                                                  jax.random.PRNGKey(1)))
    tp = params_from_numpy(tcfg, raw, device="cpu")
    jl = jax.tree_util.tree_leaves(raw)
    tl = tpm.tree_leaves(tp)
    assert len(jl) == len(tl) == len(tpm.tree_leaves(tapi.model_specs(tcfg)))
    for a, t in zip(jl, tl):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))
    first = sorted(raw)[0]
    with pytest.raises(ValueError, match="want keys"):
        params_from_numpy(tcfg, {k: v for k, v in raw.items() if k != first},
                          device="cpu")
