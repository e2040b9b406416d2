"""The port's dense transformer against the JAX package's, at the reduced
qwen3-0.6b config, with the JAX package's own initialised parameters
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
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import model_api as japi  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import model_api as tapi  # noqa: E402
from repro_torch.models import params as tpm  # noqa: E402
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
    th, _ = ttfm.forward_hidden(
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


def test_other_families_raise():
    cfg = treg.get_config("mixtral-8x7b").reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tapi.model_specs(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tapi.init_cache(cfg, 1, 16, "cpu")
    vlm = treg.get_config("phi-3-vision-4.2b").reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tapi.model_specs(vlm)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttfm.embed_inputs(vlm, {}, {})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttfm._flash_decode_shmap()
