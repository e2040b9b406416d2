"""The port's encoder-decoder family (whisper-small: an encoder over stub audio
frames, a causal decoder with cross-attention) against the JAX package's,
at the reduced whisper-small config, with the JAX package's own initialised
parameters (``init_params(cfg, PRNGKey(0))``) carried across by
``params_from_numpy`` and batches drawn by each package's ``make_batch``
from the same numpy seed.

The JAX package's encoder runs in bf16 whatever the parameters' dtype (its
input is cast to bf16, and its ``lax.scan`` carry must keep that dtype), so
the encoder, prefill and decode are compared with bf16 parameters, at
tests/test_torch_model.py's bf16 tolerance: 2**-5 of the largest reference
value, abs (cache leaves: of the largest value of the leaf). The decoder
alone (``decode_train`` over a given encoder output) is also compared with
f32 parameters, at 2e-5 abs and rel. Whisper has no kernel route, in either
package: ``use_pallas`` changes nothing.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import InputShape as JShape  # noqa: E402
from repro.models import model_api as japi  # noqa: E402
from repro.models import whisper as jwh  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import InputShape as TShape  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import model_api as tapi  # noqa: E402
from repro_torch.models import params as tpm  # noqa: E402
from repro_torch.models import whisper as twh  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "whisper-small"
SEQ = 24
CTX = 40
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jax_params():
    return japi.init_params(jreg.get_config(ARCH).reduced(),
                            jax.random.PRNGKey(0))


def _setup(jax_params, dtype="bf16", **kw):
    jdt, tdt = DTYPES[dtype]
    jcfg = jreg.get_config(ARCH).reduced().replace(**kw)
    tcfg = treg.get_config(ARCH).reduced().replace(**kw)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jdt), jax_params)
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                        jax_params),
                           dtype=tdt, device="cpu")
    return jcfg, jp, tcfg, tp


def _batches(jcfg, tcfg, seed, seq=SEQ):
    jb = japi.make_batch(jcfg, JShape("t", seq, 2, "prefill"),
                         np.random.default_rng(seed))
    tb = tapi.make_batch(tcfg, TShape("t", seq, 2, "prefill"),
                         np.random.default_rng(seed), device="cpu")
    return jb, tb


def _close(got, want, dtype="bf16"):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "bf16":
        tol = dict(atol=2 ** -5 * float(np.abs(want).max()), rtol=0)
    else:
        tol = dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, want, **tol)


def test_whisper_param_tree_matches_leaf_for_leaf(jax_params):
    jcfg = jreg.get_config(ARCH).reduced()
    tcfg = treg.get_config(ARCH).reduced()
    jleaves = jax.tree_util.tree_leaves(jax_params)
    tleaves = tpm.tree_leaves(tapi.model_specs(tcfg))
    assert [tuple(a.shape) for a in jleaves] == [s.shape for s in tleaves]
    assert tapi.param_count(tcfg) == japi.param_count(jcfg)
    # (the configs' analytic n_params(), in both packages, counts a gated
    # three-matrix MLP where whisper's has two, and leaves out enc_pos)
    assert tcfg.n_params() == jcfg.n_params()
    # the port's own init: the learned encoder positions a 0.02 normal
    p = tapi.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    std = float(p["enc_pos"].float().std())
    assert abs(std - 0.02) < 0.15 * 0.02
    assert p["dec_layers"]["ln_x"].abs().max() == 0


def test_encode_matches(jax_params):
    jcfg, jp, tcfg, tp = _setup(jax_params)
    jb, tb = _batches(jcfg, tcfg, 0)
    out = twh.encode(tcfg, tp, tb["frames"])
    assert out.dtype == torch.bfloat16
    assert out.shape == (2, tcfg.n_enc_frames, tcfg.d_model)
    _close(out, jwh.encode(jcfg, jp, jb["frames"]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_train_matches(jax_params, dtype):
    """Teacher-forced decoder logits over one encoder output (the same
    numpy draw, in the working dtype, in both packages)."""
    jcfg, jp, tcfg, tp = _setup(jax_params, dtype)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, (2, SEQ))
    enc = rng.normal(size=(2, tcfg.n_enc_frames, tcfg.d_model))
    jenc = jnp.asarray(enc, DTYPES[dtype][0])
    tenc = torch.from_numpy(np.array(jenc.astype(jnp.float32))).to(
        DTYPES[dtype][1])
    got = twh.decode_train(tcfg, tp, torch.from_numpy(toks), tenc)
    _close(got, jwh.decode_train(jcfg, jp, jnp.asarray(toks), jenc), dtype)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_caches_then_decode(jax_params, use_pallas):
    """Prefill logits and every cache leaf, the cross-attention caches
    xk/xv included, then three decode steps along both chains."""
    jcfg, jp, tcfg, tp = _setup(jax_params, use_pallas=use_pallas)
    jb, tb = _batches(jcfg, tcfg, 2)
    before = fa.flash_attention_cuda.launches
    jlog, jc = japi.prefill(jcfg, jp, jb, CTX)
    tlog, tc = tapi.prefill(tcfg, tp, tb, CTX)
    assert fa.flash_attention_cuda.launches == before
    _close(tlog, jlog)
    assert set(tc) == set(jc) == {"k", "v", "xk", "xv", "k_pos", "pos"}
    for key in ("k", "v", "xk", "xv"):
        assert tc[key].dtype == torch.bfloat16
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key])
    assert tc["k"].shape[2] == CTX + 128
    for key in ("k_pos", "pos"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    xk = tc["xk"].clone()
    for step in range(3):
        tok = np.random.default_rng(10 + step).integers(1, 512, (2, 1))
        jlog, jc = japi.decode_step(jcfg, jp, jc, {"token": jnp.asarray(tok)})
        tlog, tc = tapi.decode_step(tcfg, tp, tc,
                                    {"token": torch.from_numpy(tok)})
        _close(tlog, jlog)
        for key in ("k", "v"):
            _close(tc[key], jc[key])
        for key in ("k_pos", "pos"):
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]))
    assert torch.equal(tc["xk"], xk)              # filled once, at prefill
    assert int(tc["pos"][0]) == SEQ + 3           # the slot is pos: no wrap


def test_decode_matches_decode_train():
    """Greedy decode after prefill == argmax of the teacher-forced decoder
    over the extended prompt, on the port's own random weights (f32, so no
    bf16 near-tie decides a token)."""
    tcfg = treg.get_config(ARCH).reduced()
    tp = tpm.init(tapi.model_specs(tcfg), torch.Generator().manual_seed(3),
                  torch.float32, "cpu")
    tb = tapi.make_batch(tcfg, TShape("t", 8, 1, "prefill"),
                         np.random.default_rng(3), device="cpu")
    logits, cache = tapi.prefill(tcfg, tp, tb, 16)
    enc = twh.encode(tcfg, tp, tb["frames"])
    seq = tb["tokens"]
    for step in range(4):
        nxt = int(torch.argmax(logits[0, -1]))
        ref = twh.decode_train(tcfg, tp, seq, enc)[:, -1]
        assert int(torch.argmax(ref[0])) == nxt, step
        seq = torch.cat([seq, torch.tensor([[nxt]])], dim=1)
        logits, cache = tapi.decode_step(tcfg, tp, cache,
                                         {"token": torch.tensor([[nxt]])})
