"""The port's VLM family (the phi-3-vision backbone: stub image embeddings in
front of the token embeddings) against the JAX package's, at the reduced
phi-3-vision-4.2b config (head_dim 32) and at head_dim 96, the published
one, with the JAX package's own initialised parameters
(``init_params(cfg, PRNGKey(0))``) carried across by ``params_from_numpy``.

Each case runs with ``use_pallas`` off and on (on: the JAX side runs the
Pallas kernel in interpret mode, the port the kernel's plain version on the
CPU), at sequences the Pallas kernel takes (a multiple of 128, or below
128), with the batch drawn by each package's ``make_batch`` from the same
numpy seed. Tolerances: f32 2e-5 abs and rel, bf16 2**-5 of the largest
reference value, abs (tests/test_torch_model.py's). An f32 value stored in
the bf16 cache may round to the neighbouring bf16 value in the other
package: one bf16 step, 2**-7 of the larger of the two, beside the f32
tolerance's 2e-5 abs (a k near 0 is a difference of larger terms).

A decode step reads the bf16 cache and so rounds its attention
probabilities to bf16 (the cache's dtype), in both packages, also with f32
parameters. A probability whose f32 values differ by an ulp can round to
neighbouring bf16 values, which moves that head's output by 2**-8 of its
share; one such step moved a logit by 3.5e-3 (of a largest logit of 3.5)
here. So f32 decode logits take one bf16 rounding of the logits' scale,
2**-8 of the largest reference logit. Each step is compared from the same
cache (the JAX package's, carried across), so such gaps do not add up along
two chains; the port's own chain is held by greedy decode against a full
forward.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import InputShape as JShape  # noqa: E402
from repro.models import model_api as japi  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import InputShape as TShape  # noqa: E402
from repro_torch.models import model_api as tapi  # noqa: E402
from repro_torch.models import params as tpm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "phi-3-vision-4.2b"
HEAD_DIMS = [32, 96]
SEQS = [64, 128]      # 8 image + 56 or 120 text positions
CTX = 160
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(head_dim, **kw):
    return tuple(r.get_config(ARCH).reduced().replace(head_dim=head_dim,
                                                       **kw)
                 for r in (jreg, treg))


@pytest.fixture(scope="module")
def jax_params():
    return {d: japi.init_params(_cfgs(d)[0], jax.random.PRNGKey(0))
            for d in HEAD_DIMS}


def _setup(jax_params, head_dim, dtype, use_pallas):
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = _cfgs(head_dim, use_pallas=use_pallas)
    raw = jax_params[head_dim]
    jp = jax.tree_util.tree_map(lambda a: a.astype(jdt), raw)
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, raw),
                           dtype=tdt, device="cpu")
    return jcfg, jp, tcfg, tp


def _batches(jcfg, tcfg, seq, seed=0, kind="prefill"):
    jb = japi.make_batch(jcfg, JShape("t", seq, 2, kind),
                         np.random.default_rng(seed))
    tb = tapi.make_batch(tcfg, TShape("t", seq, 2, kind),
                         np.random.default_rng(seed), device="cpu")
    return jb, tb


def _close(got, want, dtype, kind="logits"):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "bf16":
        tol = dict(atol=2 ** -5 * float(np.abs(want).max()), rtol=0)
    elif kind == "bf16_cache":         # one bf16 step of the larger value
        assert np.all(np.abs(got - want)
                      <= 2 ** -7 * np.maximum(np.abs(got), np.abs(want))
                      + 2e-5)
        return
    elif kind == "via_bf16_probs":
        tol = dict(atol=2 ** -8 * float(np.abs(want).max()), rtol=0)
    else:
        tol = dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_vlm_param_tree_matches_leaf_for_leaf(jax_params, head_dim):
    jcfg, tcfg = _cfgs(head_dim)
    jleaves = jax.tree_util.tree_leaves(jax_params[head_dim])
    tleaves = tpm.tree_leaves(tapi.model_specs(tcfg))
    assert [tuple(a.shape) for a in jleaves] == [s.shape for s in tleaves]
    assert tapi.param_count(tcfg) == japi.param_count(jcfg)
    assert tcfg.n_params() == tapi.param_count(tcfg)


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
@pytest.mark.parametrize("arch", [ARCH, "whisper-small", "mixtral-8x7b"])
def test_make_batch_draws_the_same_values(arch, kind):
    """The same seed gives the same batch in both packages: token ids,
    image embeddings, audio frames (bf16), labels and mask."""
    jcfg = jreg.get_config(arch).reduced()
    tcfg = treg.get_config(arch).reduced()
    jb, tb = _batches(jcfg, tcfg, 64, seed=4, kind=kind)
    assert set(jb) == set(tb)
    for key in jb:
        want = np.asarray(jb[key].astype(jnp.float32))
        assert tuple(tb[key].shape) == want.shape, key
        np.testing.assert_array_equal(tb[key].float().numpy(), want)
    if kind == "prefill" and arch == ARCH:
        assert tb["image_embeds"].dtype == torch.bfloat16
        assert tb["tokens"].shape == (2, 64 - tcfg.n_img_tokens)


def test_embed_inputs_puts_the_image_in_front(jax_params):
    _, _, tcfg, tp = _setup(jax_params, 32, "f32", False)
    _, tb = _batches(*_cfgs(32), 64)
    emb = ttfm.embed_inputs(tcfg, tp, tb)
    n = tcfg.n_img_tokens
    assert emb.shape == (2, 64, tcfg.d_model)
    torch.testing.assert_close(emb[:, :n], tb["image_embeds"].float())
    torch.testing.assert_close(emb[:, n:], tp["embed"][tb["tokens"]])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_vlm_forward_logits(jax_params, head_dim, dtype, use_pallas):
    jcfg, jp, tcfg, tp = _setup(jax_params, head_dim, dtype, use_pallas)
    jb, tb = _batches(jcfg, tcfg, 128)
    jh, _, jaux = jtfm.forward_hidden(jcfg, jp,
                                      jtfm.embed_inputs(jcfg, jp, jb))
    th, _, aux = ttfm.forward_hidden(tcfg, tp,
                                     ttfm.embed_inputs(tcfg, tp, tb))
    _close(ttfm.logits_fn(tcfg, tp, th), jtfm.logits_fn(jcfg, jp, jh), dtype)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_vlm_prefill_then_decode(jax_params, head_dim, dtype, use_pallas,
                                 seq):
    """model_api.prefill over image + text, every cache leaf, then three
    decode steps of text tokens."""
    jcfg, jp, tcfg, tp = _setup(jax_params, head_dim, dtype, use_pallas)
    jb, tb = _batches(jcfg, tcfg, seq, seed=1)
    jlog, jc = japi.prefill(jcfg, jp, jb, CTX)
    tlog, tc = tapi.prefill(tcfg, tp, tb, CTX)
    _close(tlog, jlog, dtype)
    _close(tc["k"], jc["k"], dtype, "bf16_cache")
    _close(tc["v"], jc["v"], dtype, "bf16_cache")
    for key in ("k_pos", "pos"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    assert int(tc["pos"][0]) == seq           # image + text positions
    for step in range(3):
        tok = np.random.default_rng(10 + step).integers(1, 512, (2, 1))
        start = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
            tc[k].dtype) for k, v in jc.items()}
        jlog, jc = japi.decode_step(jcfg, jp, jc, {"token": jnp.asarray(tok)})
        tlog, tc = tapi.decode_step(tcfg, tp, start,
                                    {"token": torch.from_numpy(tok)})
        _close(tlog, jlog, dtype, "via_bf16_probs")
        for key in ("k_pos", "pos"):
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_vlm_decode_matches_full_forward(jax_params, head_dim, use_pallas):
    """Greedy decode after an image + text prefill == argmax of a full
    re-forward over the same image and the extended text (bf16 parameters,
    as tests/test_models.py's twin)."""
    _, _, tcfg, tp = _setup(jax_params, head_dim, "bf16", use_pallas)
    _, tb = _batches(*_cfgs(head_dim), 32, seed=2)
    tb = {k: v[:1] for k, v in tb.items()}
    logits, cache = tapi.prefill(tcfg, tp, tb, 96)
    seq = tb["tokens"]
    for step in range(3):
        nxt = int(torch.argmax(logits[0, -1]))
        emb = ttfm.embed_inputs(tcfg, tp, dict(tb, tokens=seq))
        h, _, _ = ttfm.forward_hidden(tcfg, tp, emb)
        ref = ttfm.logits_fn(tcfg, tp, h[:, -1:, :])
        assert int(torch.argmax(ref[0, -1])) == nxt, step
        seq = torch.cat([seq, torch.tensor([[nxt]])], dim=1)
        logits, cache = tapi.decode_step(tcfg, tp, cache,
                                         {"token": torch.tensor([[nxt]])})
