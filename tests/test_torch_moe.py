"""The port's MoE family against the JAX package's: reduced mixtral-8x7b (4
experts, top-2, sliding window) and reduced dbrx-132b (16 experts, top-4
as published), with the JAX package's own initialised parameters
(``init_params(cfg, PRNGKey(0))``) carried across by ``params_from_numpy``,
under both dispatches (``moe_impl`` "einsum" and "sorted").

Tolerances are tests/test_torch_model.py's: f32 2e-5 abs and rel; bf16
2**-5 of the largest reference value, abs. Routing (each token's experts)
is compared exactly, and the load-balancing loss at the f32 tolerance.

The reduced configs take capacity_factor 8.0 and never drop a token; the
cases at capacity_factor 1.0 and 0.5 do drop, and there the outputs equal
the reference's only if both drop the same (token, choice) pairs.

The expert choice is discrete: a rounding that differs between the two
frameworks can move a near-tie of two router probabilities to another
expert, which changes that token's output by a whole expert's part. So the
model-level cases record the JAX package's choices in every MoE layer (its
``top_k`` indices, through a debug callback) and, in f32, require the
port's own choices to equal them; in bf16 the port replays them, with its
own gates at those experts (``Routing``). Decode steps are compared from
the same cache (the JAX package's, carried across), not along two chains;
the port's own chain is held by greedy decode against a full forward.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import model_api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import model_api as tapi  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import params as tpm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCHS = {"mixtral": "mixtral-8x7b", "dbrx": "dbrx-132b"}
IMPLS = ["einsum", "sorted"]
SEQ = 64              # the reduced mixtral's window; a multiple of K3's 64
CTX = 96
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jax_params():
    return {name: japi.init_params(jreg.get_config(arch).reduced(),
                                   jax.random.PRNGKey(0))
            for name, arch in ARCHS.items()}


def _cfgs(name, **kw):
    arch = ARCHS[name]
    return (jreg.get_config(arch).reduced().replace(**kw),
            treg.get_config(arch).reduced().replace(**kw))


def _setup(jax_params, name, dtype, **kw):
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = _cfgs(name, **kw)
    raw = jax_params[name]
    jp = jax.tree_util.tree_map(lambda a: a.astype(jdt), raw)
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, raw),
                           dtype=tdt, device="cpu")
    return jcfg, jp, tcfg, tp


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "bf16":
        tol = dict(atol=2 ** -5 * float(np.abs(want).max()), rtol=0)
    else:
        tol = dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, want, **tol)


class Routing:
    """Records the JAX package's expert choices (top_i of each MoE layer in
    call order) and routes the port's MoE layers against them: the port's
    own choices must equal them (``replay`` False) or are replaced by them
    (``replay`` True). The JAX side runs first in every pair of calls."""

    def __init__(self, monkeypatch, replay):
        self.jax, self.calls, self.replay = [], 0, replay
        real_top_k, real_route = jax.lax.top_k, tmoe.route

        def top_k(x, k):
            v, i = real_top_k(x, k)
            jax.debug.callback(lambda a: self.jax.append(np.asarray(a)), i,
                               ordered=True)
            return v, i

        def route(cfg, p, x):
            probs, top_p, top_i, aux = real_route(cfg, p, x)
            jax.effects_barrier()
            want = torch.from_numpy(self.jax[self.calls]).long()
            self.calls += 1
            if not self.replay:
                np.testing.assert_array_equal(top_i.numpy(), want.numpy())
                return probs, top_p, top_i, aux
            top_p = probs.gather(-1, want)
            return probs, top_p / top_p.sum(-1, keepdim=True), want, aux

        monkeypatch.setattr(jax.lax, "top_k", top_k)
        monkeypatch.setattr(tmoe, "route", route)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(1, 512, shape)


def _x(seed, cfg, dtype, s=SEQ):
    """The same (2, s, d_model) activations in both frameworks, rounded once
    to the working dtype."""
    x = np.random.default_rng(seed).normal(size=(2, s, cfg.d_model))
    jx = jnp.asarray(x, DTYPES[dtype][0])
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        DTYPES[dtype][1])


def _jax_top_i(cfg, p, x):
    """The JAX package's routing lines (moe_block, :44-47)."""
    probs = jax.nn.softmax(x.astype(jnp.float32)
                           @ p["router"].astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])


def _dropped(top_i, cfg, s):
    """(token, choice) pairs past their expert's capacity, in the JAX
    package's (token, choice)-major order."""
    b = top_i.shape[0]
    cap = jmoe._capacity(cfg, s)
    flat = top_i.reshape(b, -1)
    seen = np.zeros((b, cfg.n_experts), int)
    out = np.zeros(flat.shape, bool)
    for r in range(b):
        for j, e in enumerate(flat[r]):
            out[r, j] = seen[r, e] >= cap
            seen[r, e] += 1
    return out


@pytest.mark.parametrize("name", list(ARCHS))
def test_moe_param_tree_matches_leaf_for_leaf(jax_params, name):
    jcfg, tcfg = _cfgs(name)
    jleaves = jax.tree_util.tree_leaves(jax_params[name])
    tleaves = tpm.tree_leaves(tapi.model_specs(tcfg))
    assert [tuple(a.shape) for a in jleaves] == [s.shape for s in tleaves]
    assert tapi.param_count(tcfg) == japi.param_count(jcfg)
    assert tcfg.n_params() == tapi.param_count(tcfg)
    p = tapi.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert set(p["layers"]) == {"ln1", "ln2", "attn", "moe"}
    assert p["layers"]["moe"]["wi"].shape == (
        tcfg.num_layers, tcfg.n_experts, tcfg.d_model, tcfg.d_ff)


@pytest.mark.parametrize("s", [1, 5, 64, 100])
@pytest.mark.parametrize("cf", [8.0, 1.25, 1.0, 0.5])
@pytest.mark.parametrize("name", list(ARCHS))
def test_capacity_matches(name, cf, s):
    jcfg, tcfg = _cfgs(name, capacity_factor=cf)
    assert tmoe._capacity(tcfg, s) == jmoe._capacity(jcfg, s)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_routing_and_aux_loss_match(jax_params, name, dtype):
    """The same experts for every token, in the same order, and the same
    load-balancing loss."""
    jcfg, jp, tcfg, tp = _setup(jax_params, name, dtype)
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    tlayer = tpm.tree_index(tp["layers"], 0)["moe"]
    jx, tx = _x(1, tcfg, dtype)
    _, top_p, top_i, aux = tmoe.route(tcfg, tlayer, tx)
    np.testing.assert_array_equal(top_i.numpy(),
                                  _jax_top_i(jcfg, jlayer, jx))
    np.testing.assert_allclose(top_p.sum(-1).numpy(), 1.0, rtol=1e-6)
    _, jaux = jmoe.moe_block(jcfg, jlayer, jx)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-5, atol=0)


def test_routing_breaks_ties_to_the_lower_index():
    """jax.lax.top_k puts the lower expert first among equal
    probabilities; so does the port's router (a zero router makes every
    probability equal)."""
    cfg = treg.get_config("dbrx-132b").reduced()
    p = {"router": torch.zeros(cfg.d_model, cfg.n_experts)}
    _, top_p, top_i, _ = tmoe.route(cfg, p, torch.randn(2, 5, cfg.d_model))
    want = torch.arange(cfg.top_k).expand(2, 5, cfg.top_k)
    assert torch.equal(top_i, want)
    jx = jnp.zeros((2, 5, cfg.d_model))
    jtop = jax.lax.top_k(jax.nn.softmax(jx @ jnp.zeros((cfg.d_model,
                                                        cfg.n_experts))),
                         cfg.top_k)[1]
    np.testing.assert_array_equal(np.asarray(jtop), want.numpy())


@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(ARCHS))
def test_moe_block_matches(jax_params, name, impl, dtype, cf):
    """One layer's MoE block on the same activations: the output and the
    aux loss; at capacity_factor <= 1.0 some choices drop, and the outputs
    agree only where the same choices drop."""
    jcfg, jp, tcfg, tp = _setup(jax_params, name, dtype, moe_impl=impl,
                                capacity_factor=cf)
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    tlayer = tpm.tree_index(tp["layers"], 0)["moe"]
    jx, tx = _x(2, tcfg, dtype)
    y, aux = tmoe.moe_block(tcfg, tlayer, tx)
    jy, jaux = jmoe.moe_block(jcfg, jlayer, jx)
    assert y.dtype == tx.dtype
    _close(y, jy, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-5, atol=0)
    n_dropped = _dropped(_jax_top_i(jcfg, jlayer, jx), jcfg, SEQ).sum()
    assert (n_dropped > 0) == (cf <= 1.0)


@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5])
@pytest.mark.parametrize("name", list(ARCHS))
def test_dispatches_drop_the_same_choices(jax_params, name, cf):
    """The sorted dispatch equals the einsum dispatch, and a dropped choice
    adds nothing: zeroing the gate of every dropped (token, choice) in a
    no-drop run gives the dropping run's output (f32)."""
    _, _, tcfg, tp = _setup(jax_params, name, "f32", capacity_factor=cf)
    tlayer = tpm.tree_index(tp["layers"], 0)["moe"]
    _, tx = _x(3, tcfg, "f32")
    ye, _ = tmoe.moe_block(tcfg, tlayer, tx)
    ys, _ = tmoe.moe_block(tcfg.replace(moe_impl="sorted"), tlayer, tx)
    torch.testing.assert_close(ys, ye, atol=2e-5, rtol=2e-5)
    _, top_p, top_i, _ = tmoe.route(tcfg, tlayer, tx)
    drop = torch.from_numpy(_dropped(top_i.numpy(), tcfg, SEQ)).reshape(
        top_i.shape)
    assert bool(drop.any()) == (cf <= 1.0)
    big = tcfg.n_experts * SEQ             # no expert ever fills
    y0 = tmoe._group_sorted(tcfg.replace(capacity_factor=8.0), tlayer["wi"],
                            tlayer["wg"], tlayer["wo"], tx,
                            top_p.masked_fill(drop, 0.0), top_i, big)
    torch.testing.assert_close(ye, y0, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_sorted_shard_map_is_the_sorted_dispatch_without_a_mesh(jax_params,
                                                                 cf):
    """Without a mesh "sorted_shmap" falls back to the sorted dispatch, as
    the JAX package's does: the same outputs and aux loss, bit for bit. Its
    local body runs on four CPU ranks in tests/test_torch_mesh_ranks.py."""
    _, _, tcfg, tp = _setup(jax_params, "mixtral", "bf16",
                            capacity_factor=cf)
    tlayer = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    _, tx = _x(3, tcfg, "bf16")
    y1, a1 = tmoe.moe_block(tcfg.replace(moe_impl="sorted_shmap"), tlayer,
                            tx)
    y2, a2 = tmoe.moe_block(tcfg.replace(moe_impl="sorted"), tlayer, tx)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    assert float(a1) == float(a2)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(ARCHS))
def test_forward_logits_and_aux(jax_params, monkeypatch, name, impl, dtype,
                                use_pallas):
    jcfg, jp, tcfg, tp = _setup(jax_params, name, dtype, moe_impl=impl,
                                use_pallas=use_pallas)
    routing = Routing(monkeypatch, replay=dtype == "bf16")
    toks = _tokens(0, (2, SEQ))
    jh, _, jaux = jtfm.forward_hidden(
        jcfg, jp, jtfm.embed_inputs(jcfg, jp, {"tokens": jnp.asarray(toks)}))
    th, _, aux = ttfm.forward_hidden(
        tcfg, tp, ttfm.embed_inputs(tcfg, tp,
                                    {"tokens": torch.from_numpy(toks)}))
    _close(ttfm.logits_fn(tcfg, tp, th), jtfm.logits_fn(jcfg, jp, jh), dtype)
    if dtype == "f32":      # replayed choices keep the port's own aux
        np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-5,
                                   atol=0)
    assert routing.calls == tcfg.num_layers


def _jax_cache_in_port(jc):
    return {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16) if v.dtype == jnp.bfloat16 else
        torch.from_numpy(np.asarray(v)) for k, v in jc.items()}


def _prefill_then_decode(jax_params, monkeypatch, name, dtype, use_pallas,
                         lens):
    jcfg, jp, tcfg, tp = _setup(jax_params, name, dtype,
                                use_pallas=use_pallas)
    routing = Routing(monkeypatch, replay=dtype == "bf16")
    toks = _tokens(1, (2, SEQ))
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if lens is not None:
        jb["prompt_lens"] = jnp.asarray(lens)
        tb["prompt_lens"] = torch.from_numpy(lens)
    jlog, jc = japi.prefill(jcfg, jp, jb, CTX)
    tlog, tc = tapi.prefill(tcfg, tp, tb, CTX)
    _close(tlog, jlog, dtype)
    for key in ("k", "v"):
        got, want = tc[key].float().numpy(), np.asarray(jc[key], np.float32)
        if dtype == "bf16":
            _close(got, want, dtype)
        else:    # f32 values stored in bf16: neighbouring bf16 values
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=2 ** -7)
    for key in ("k_pos", "pos"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    for step in range(3):
        tok = _tokens(10 + step, (2, 1))
        start = _jax_cache_in_port(jc)
        jlog, jc = japi.decode_step(jcfg, jp, jc, {"token": jnp.asarray(tok)})
        tlog, tc = tapi.decode_step(tcfg, tp, start,
                                    {"token": torch.from_numpy(tok)})
        _close(tlog, jlog, dtype)
        for key in ("k_pos", "pos"):
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]))
    assert routing.calls == 4 * tcfg.num_layers


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_uniform_prefill_then_decode(jax_params, monkeypatch, name, dtype,
                                     use_pallas):
    _prefill_then_decode(jax_params, monkeypatch, name, dtype, use_pallas,
                         None)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_ragged_prefill_then_decode(jax_params, monkeypatch, name, dtype,
                                    use_pallas):
    """Right-padded prompts: the pad tokens of the shorter row are routed
    and take capacity, as in the JAX package."""
    _prefill_then_decode(jax_params, monkeypatch, name, dtype, use_pallas,
                         np.array([37, SEQ], np.int32))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_matches_full_forward(jax_params, name, impl):
    """Twin of tests/test_models.py's test_decode_matches_full_forward
    (mixtral there), in the port: greedy decode after prefill == argmax of
    a full re-forward (bf16 parameters, as there)."""
    _, _, tcfg, tp = _setup(jax_params, name, "bf16", moe_impl=impl)
    toks = np.random.default_rng(1).integers(1, tcfg.vocab_size, (1, 16))
    logits, cache = tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                 48)
    seq = list(toks[0])
    for step in range(3):
        nxt = int(torch.argmax(logits[0, -1]))
        emb = ttfm.embed_inputs(tcfg, tp, {"tokens": torch.tensor([seq])})
        h, _, _ = ttfm.forward_hidden(tcfg, tp, emb)
        ref_logits = ttfm.logits_fn(tcfg, tp, h[:, -1:, :])
        assert int(torch.argmax(ref_logits[0, -1])) == nxt, \
            f"{name}: decode diverges at step {step}"
        seq.append(nxt)
        logits, cache = tapi.decode_step(tcfg, tp, cache,
                                         {"token": torch.tensor([[nxt]])})
