"""The port's serving engine: twins of the JAX engine's tests in
tests/test_substrate.py, plus teacher-forced parity with the JAX engine, for
the dense family (reduced qwen3-0.6b) and the recurrent ones (reduced
mamba2-2.7b, and recurrentgemma-9b at ``num_layers=5``: one super-block and
both tail blocks).

Parameters are the JAX package's ``init_params(cfg, PRNGKey(0))`` (bf16)
carried across by ``params_from_numpy``. Teacher forcing feeds the JAX
engine's generated tokens through the port's prefill and decode steps and
compares the logits step by step at the bf16 tolerance of
tests/test_torch_model.py (2**-5 of the largest reference logit, abs, at its
2 layers), scaled by sqrt(layers / 2) for deeper stacks: the two frameworks'
bf16 roundings differ layer by layer and their gap grows as a random walk
over the layers (at the hybrid's 5 layers each framework's bf16 logits lie
up to 0.034 of the largest logit from an f32 run, and the two up to 0.034
from each other). A token where the JAX engine's top two logits are closer
than that tolerance is a tie the two frameworks may break differently, and
is not compared by argmax.

The recurrent families do not read ``prompt_lens`` in prefill, in the JAX
package as in the port: the engine's pad tokens run through the recurrence,
the first token comes from the last pad position and decoding starts at the
bucket length. The tests pin that, on prompts whose lengths are not buckets.

The MoE family (reduced mixtral-8x7b) is served as the dense one is. Its
pad tokens are routed like any token and take capacity, in the JAX engine
as in the port: a group's capacity follows the padded bucket, not the
prompt. The test runs at capacity_factor 1.0, where prefill drops choices,
so the two engines agree only if they drop the same ones.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import model_api as japi  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import model_api as tapi  # noqa: E402
from repro_torch.models import params as tpm  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Request, ServingEngine, _buckets)

ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module")
def jax_params():
    return japi.init_params(jreg.get_config(ARCH).reduced(),
                            jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_params(jax_params):
    cfg = treg.get_config(ARCH).reduced()
    return params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                         jax_params),
                             device="cpu")


def _requests(cls, n, lo, hi, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, 512, int(rng.integers(lo, hi))
                                           ).astype(np.int32),
                max_new_tokens=max_new) for i in range(n)]


def test_buckets_match():
    for n in (16, 64, 96, 1024):
        assert _buckets(n) == jeng._buckets(n)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_batch_equals_layers_regression(port_params, use_pallas):
    """batch_size == num_layers: the JAX engine once confused the cache's
    batch axis with its layer axis; the port indexes the batch axis."""
    cfg = treg.get_config(ARCH).reduced().replace(use_pallas=use_pallas)
    assert cfg.num_layers == 2
    eng = ServingEngine(cfg, port_params, batch_size=2, max_context=64)
    reqs = _requests(Request, 3, 8, 9, 4)
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert all(len(r.out_tokens) == 4 for r in reqs)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_continuous_batching_and_consistency(port_params, use_pallas):
    cfg = treg.get_config(ARCH).reduced().replace(use_pallas=use_pallas)
    eng = ServingEngine(cfg, port_params, batch_size=3, max_context=96)
    reqs = _requests(Request, 5, 4, 40, 6)
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert all(len(r.out_tokens) == 6 for r in reqs)
    assert eng.stats()["slot_utilization"] > 0.3

    # the same tokens from a sequential full forward, one request
    r = reqs[0]
    toks = list(r.prompt)
    for expect in r.out_tokens:
        batch = {"tokens": torch.tensor([toks], dtype=torch.int64)}
        emb = ttfm.embed_inputs(cfg, port_params, batch)
        h, _, _ = ttfm.forward_hidden(cfg, port_params, emb)
        logits = ttfm.logits_fn(cfg, port_params, h[:, -1:, :])
        assert int(torch.argmax(logits[0, -1])) == expect
        toks.append(expect)


def _teacher_forced(jcfg, tcfg, jax_params, port_params, jreqs, ctx):
    """Feed the JAX engine's tokens through the port's prefill and decode
    steps; returns how many steps were compared by argmax."""
    depth = (tcfg.num_layers / 2) ** 0.5      # 1 at the dense test's depth
    compared = 0
    for r in jreqs:
        n = len(r.prompt)
        pad = next(b for b in _buckets(ctx) if n <= b)
        tokens = np.zeros((1, pad), np.int64)
        tokens[0, :n] = r.prompt
        batch = {"tokens": tokens, "prompt_lens": np.array([n], np.int32)}
        jlog, jc = japi.prefill(jcfg, jax_params,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                ctx)
        tlog, tc = tapi.prefill(tcfg, port_params,
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, ctx)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        for step, tok in enumerate(r.out_tokens):
            want = np.asarray(jlog, np.float32).reshape(-1)
            got = tlog.float().numpy().reshape(-1)
            tol = depth * 2 ** -5 * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, atol=tol, rtol=0)
            top2 = np.sort(want)[-2:]
            if top2[1] - top2[0] > tol:
                assert int(np.argmax(want)) == tok, (r.rid, step)
                assert int(np.argmax(got)) == tok, (r.rid, step)
                compared += 1
            feed = np.array([[tok]], np.int64)
            jlog, jc = japi.decode_step(jcfg, jax_params, jc,
                                        {"token": jnp.asarray(feed)})
            tlog, tc = tapi.decode_step(tcfg, port_params, tc,
                                        {"token": torch.from_numpy(feed)})
    return compared


def test_teacher_forced_parity_with_jax_engine(jax_params, port_params):
    jcfg = jreg.get_config(ARCH).reduced()
    tcfg = treg.get_config(ARCH).reduced()
    jreqs = _requests(jeng.Request, 2, 10, 30, 5, seed=3)
    jeng.ServingEngine(jcfg, jax_params, batch_size=2,
                       max_context=64).run(jreqs)
    compared = _teacher_forced(jcfg, tcfg, jax_params, port_params, jreqs, 64)
    assert compared >= len(jreqs)     # not every step a near-tie


# ---------------------------------------------------------------------------
# The recurrent families
# ---------------------------------------------------------------------------

RECURRENT = {"mamba2": ("mamba2-2.7b", 2), "rglru-5": ("recurrentgemma-9b", 5)}


def _rec_cfgs(name, **kw):
    arch, layers = RECURRENT[name]
    return tuple(c.reduced().replace(num_layers=layers, **kw)
                 for c in (jreg.get_config(arch), treg.get_config(arch)))


@pytest.fixture(scope="module")
def rec_models():
    out = {}
    for name in RECURRENT:
        jcfg, tcfg = _rec_cfgs(name)
        jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
        out[name] = (jp, params_from_numpy(
            tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return out


@pytest.mark.parametrize("name", list(RECURRENT))
def test_recurrent_teacher_forced_parity_with_jax_engine(rec_models, name):
    """Prompts of 10 and 23 tokens (buckets 16 and 32): the JAX engine's
    tokens, fed through the port, give the JAX logits at every step, and
    both engines start decoding at the bucket length."""
    jcfg, tcfg = _rec_cfgs(name)
    jp, tp = rec_models[name]
    rng = np.random.default_rng(5)
    jreqs = [jeng.Request(rid=i, prompt=rng.integers(1, 512, n).astype(
        np.int32), max_new_tokens=5) for i, n in enumerate((10, 23))]
    jeng_ = jeng.ServingEngine(jcfg, jp, batch_size=2, max_context=64)
    teng = ServingEngine(tcfg, tp, batch_size=2, max_context=64)
    for r in jreqs:
        jeng_.submit(r)
        teng.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=5))
    jeng_._admit()
    teng._admit()
    np.testing.assert_array_equal(np.asarray(jeng_.cache["pos"]), [16, 32])
    np.testing.assert_array_equal(teng.cache["pos"].numpy(), [16, 32])
    jeng_.run([])                     # serve the admitted requests to the end
    assert all(r.done and len(r.out_tokens) == 5 for r in jreqs)
    compared = _teacher_forced(jcfg, tcfg, jp, tp, jreqs, 64)
    assert compared >= len(jreqs)     # not every step a near-tie


@pytest.mark.parametrize("name,layers", [("mamba2", 2), ("rglru-5", 6)])
def test_recurrent_engine_batch_equals_stacked_layers(name, layers):
    """batch_size == the stacked layer count (mamba2's 2 layers; the
    hybrid's 2 super-blocks at num_layers=6): every cache leaf is written
    into its slot by its spec's batch axis. Each request's tokens equal a
    greedy full forward over its bucket-padded prompt (f32 parameters, so
    no bf16 near-tie decides a token)."""
    cfg = _rec_cfgs(name)[1].replace(num_layers=layers)
    params = tpm.init(tapi.model_specs(cfg), torch.Generator().manual_seed(0),
                      torch.float32, "cpu")
    eng = ServingEngine(cfg, params, batch_size=2, max_context=64)
    reqs = _requests(Request, 3, 5, 30, 4, seed=6)
    eng.run(reqs)
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    mod = tm2 if cfg.family == "ssm" else trg
    for r in reqs:
        n = len(r.prompt)
        seq = list(r.prompt) + [0] * (eng._bucket_len(n) - n)
        for expect in r.out_tokens:
            h, _, _ = mod.forward_hidden(
                cfg, params, params["embed"][torch.tensor([seq])])
            logits = ttfm.logits_fn(cfg, params, h[:, -1:, :])
            assert int(torch.argmax(logits[0, -1])) == expect, r.rid
            seq.append(expect)


# ---------------------------------------------------------------------------
# The MoE family
# ---------------------------------------------------------------------------

MOE_CF = 1.0      # the reduced config's 8.0 never drops a choice; 1.0 does


def _moe_cfgs():
    return tuple(r.get_config("mixtral-8x7b").reduced().replace(
        capacity_factor=MOE_CF) for r in (jreg, treg))


@pytest.fixture(scope="module")
def moe_models():
    jcfg, tcfg = _moe_cfgs()
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def test_moe_engine_parity_with_jax_engine(moe_models):
    """Prompts of 10 and 23 tokens (buckets 16 and 32): both engines start
    decoding at the prompt length and give the same first token; the JAX
    engine's tokens, fed through the port, give the JAX logits at every
    step. The bucket's pad tokens take capacity: prefilling the bare prompt
    instead (the capacity of 10 tokens, not 16) moves the logits by more
    than the parity's tolerance (they are equal bit for bit where nothing
    drops), so the parity would catch a port that left them out."""
    from repro_torch.models import moe as tmoe
    jcfg, tcfg = _moe_cfgs()
    jp, tp = moe_models
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (10, 23)]
    jreqs = [jeng.Request(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    jeng.ServingEngine(jcfg, jp, batch_size=2, max_context=64).run(jreqs)
    teng = ServingEngine(tcfg, tp, batch_size=2, max_context=64)
    teng.run(treqs)
    assert all(r.done and len(r.out_tokens) == 5 for r in jreqs + treqs)
    assert [r.out_tokens[0] for r in treqs] == [r.out_tokens[0]
                                                for r in jreqs]
    compared = _teacher_forced(jcfg, tcfg, jp, tp, jreqs, 64)
    assert compared >= len(jreqs)     # not every step a near-tie

    assert tmoe._capacity(tcfg, 16) > tmoe._capacity(tcfg, 10)
    padded = np.zeros((1, 16), np.int64)
    padded[0, :10] = prompts[0]
    lp, _ = tapi.prefill(tcfg, tp, {
        "tokens": torch.from_numpy(padded),
        "prompt_lens": torch.tensor([10], dtype=torch.int32)}, 64)
    lb, _ = tapi.prefill(tcfg, tp, {
        "tokens": torch.from_numpy(padded[:, :10])}, 64)
    gap = float((lp.float() - lb.float()).abs().max())
    assert gap > 2 ** -5 * float(lp.float().abs().max())   # not rounding


# ---------------------------------------------------------------------------
# Stamps, counters and profiler ranges
# ---------------------------------------------------------------------------

# (prompt length, new tokens). With two slots: the first two are admitted
# at once; the third waits for the second's slot and decodes alone from the
# third step on: 4 decode steps, 6 active rows of 8.
SERVED = ((5, 3), (9, 2), (62, 4))
# family -> (arch, layers, capacity, live keys). A row's live keys at a
# decode step are its cache position after prefill (the prompt; the hybrid
# runs its pad tokens through, so the bucket: 16, 16, 64), plus the tokens
# decoded so far and this step's, capped at the capacity: dense
# 6+7, 10, 63+64+65; MoE (window 64) 6+7, 10, 63+64+64; hybrid (window
# 32) 17+18, 17, 32+32+32.
COUNTED = {"dense": ("qwen3-0.6b", 2, 64 + 128, 215),
           "moe": ("mixtral-8x7b", 2, 64, 214),
           "hybrid": ("recurrentgemma-9b", 3, 32, 148)}


def _f32_engine(family):
    arch, layers, _, _ = COUNTED[family]
    cfg = treg.get_config(arch).reduced().replace(num_layers=layers)
    params = tpm.init(tapi.model_specs(cfg), torch.Generator().manual_seed(0),
                      torch.float32, "cpu")
    eng = ServingEngine(cfg, params, batch_size=2, max_context=64)
    rng = np.random.default_rng(11)
    reqs = [Request(rid=i, prompt=rng.integers(1, 512, n).astype(np.int32),
                    max_new_tokens=m) for i, (n, m) in enumerate(SERVED)]
    return cfg, eng, reqs


@pytest.mark.parametrize("family", list(COUNTED))
def test_engine_stamps_and_counters(family):
    """Every request is stamped submitted <= admitted <= first token on the
    engine's clock, and the decode batches' counters equal hand counts."""
    _, cap, live = COUNTED[family][1:]
    _, eng, reqs = _f32_engine(family)
    eng.run(reqs)
    assert all(r.done for r in reqs)
    for r in reqs:
        assert r.submitted_s <= r.admitted_s <= r.first_token_s <= r.done_s
    st = eng.stats()
    assert st["decode_steps"] == 4
    assert st["tokens_generated"] == 6
    assert eng.cap == cap
    assert st["keys_live"] == live


def _nested_in(inner, outers):
    return all(any(o.time_range.start <= i.time_range.start
                   and i.time_range.end <= o.time_range.end for o in outers)
               for i in inner)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_engine_profiler_ranges(family):
    """Under a CPU profiler: one ``decode.attend`` a layer and decode step,
    one ``layer.moe`` a layer and prefill or decode step in the MoE model,
    one ``engine.retire`` a step, one ``engine.admit`` a step that admits;
    each inside the range that holds it."""
    from torch.profiler import ProfilerActivity, profile
    cfg, eng, reqs = _f32_engine(family)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(reqs)
    ev = {}
    for e in prof.events():
        ev.setdefault(e.name, []).append(e)
    steps, layers = eng.stats()["decode_steps"], cfg.num_layers
    assert len(ev["engine.decode_step"]) == len(ev["engine.retire"]) == steps
    assert len(ev["engine.admit"]) == 2
    assert len(ev["engine.prefill"]) == len(reqs)
    assert len(ev["decode.attend"]) == layers * steps
    assert _nested_in(ev["decode.attend"], ev["engine.decode_step"])
    assert _nested_in(ev["engine.prefill"], ev["engine.admit"])
    if family == "moe":
        assert len(ev["layer.moe"]) == layers * (steps + len(reqs))
        assert _nested_in(ev["layer.moe"], ev["engine.decode_step"]
                          + ev["engine.prefill"])
    else:
        assert "layer.moe" not in ev


def test_ranges_open_nothing_without_a_profiler(monkeypatch):
    """With no profiler running the engine and the model open no range;
    under one they open every range."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import ranges
    entered = []
    real = ranges._host_range

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(ranges, "_host_range", counting)
    _, eng, reqs = _f32_engine("moe")
    eng.run(reqs)
    assert entered == []
    _, eng, reqs = _f32_engine("moe")
    with profile(activities=[ProfilerActivity.CPU]):
        eng.run(reqs)
    assert set(entered) == {"engine.admit", "engine.prefill", "layer.moe",
                            "engine.decode_step", "decode.attend",
                            "engine.retire"}
