"""The port on device meshes of four CPU ranks (gloo), against its own
unsharded runs and the JAX package: the sharded train step (five families),
the split-K flash decode over the sequence-sharded cache, the sorted MoE
dispatch on local shards, the kernels' local-shard wrapper, and a
checkpoint saved on one mesh and restored onto another.

The ranks are spawned once for the module (``mesh_rank_cases.run_ranks``);
each test reads its part of rank 0's results."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_rank_cases as mc
from train_cases import one_torch_thread  # noqa: F401  (module fixture)
from repro import sharding as jshd
from repro.configs import registry as jreg
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models import moe as jmoe
from repro_torch.checkpoint.checkpointer import _flatten_with_paths
from repro_torch.kernels import ops
from repro_torch.models import model_api as api
from repro_torch.models import moe as tmoe
from repro_torch.models import params as pm
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

# AdamW's first step moves a parameter by lr * g / (|g| + eps), about
# +-lr (lr = 3e-4 / 100 warmup steps at step 1), plus the weight decay: a
# gradient entry near zero whose sign the order of the cross-rank sums
# flips moves by up to 2 * lr.
PARAM_ATOL = 2 * 3e-6 + 1e-6
# m and v are sums of the gradients over the ranks' rows, in another order
# than one process sums them: f32 rounding, relative to the leaf's largest
# entry. whisper's encoder runs in bf16 whatever the parameters' dtype (the
# reference's encoder casts its input), and its output feeds every decoder
# layer's cross-attention, so whisper's gradients carry bf16 rounding, which
# the changed order moves by up to a few bf16 ulps.
STATE_RTOL, BF16_STATE_RTOL = 1e-4, 2e-2


@pytest.fixture(scope="module")
def ranks():
    return mc.run_ranks()


def _np(tree):
    return pm.tree_map(lambda t: t.detach().float().numpy()
                       if torch.is_tensor(t) else t, tree)


def _unsharded(archs, num_microbatches):
    oc = opt.OptConfig()
    out = {}
    for arch in archs:
        cfg = mc.train_config(arch)
        state = opt.init_state(oc, api.model_specs(cfg), device="cpu")
        p, s, m = ts.make_train_step(cfg, oc, num_microbatches)(
            mc.f32_params(cfg), state, mc.train_batch(cfg))
        out[arch] = {"params": _np(p), "state": _np(s), "metrics": _np(m)}
    return out


@pytest.fixture(scope="module")
def unsharded_train():
    return _unsharded(mc.TRAIN_ARCHS, 1)


@pytest.fixture(scope="module")
def unsharded_train_mb():
    return _unsharded(mc.MB_ARCHS, mc.MICROBATCHES)


@pytest.mark.parametrize("mesh", mc.MESHES, ids=lambda m: "x".join(map(
    str, m)))
@pytest.mark.parametrize("arch", mc.TRAIN_ARCHS)
def test_sharded_train_step_matches_unsharded(ranks, unsharded_train, arch,
                                              mesh):
    _assert_step_equal(ranks[mesh]["train"][arch], unsharded_train[arch],
                       arch)


@pytest.mark.parametrize("arch", mc.MB_ARCHS)
def test_sharded_microbatched_step_matches_unsharded(ranks,
                                                     unsharded_train_mb,
                                                     arch):
    """Two microbatches on (2, 2): each takes the whole batch's
    consecutive rows, as the unsharded step's do (one row from each data
    rank), so the per-microbatch masked mean and MoE aux loss are those of
    the same rows. Tolerances as the one-microbatch step's."""
    _assert_step_equal(ranks[mc.MB_MESH]["train_mb"][arch],
                       unsharded_train_mb[arch], arch)


def _assert_step_equal(got, want, arch):
    assert got["placed"], "outputs not in the declared placements"
    assert float(got["metrics"]["loss"]) == pytest.approx(
        float(want["metrics"]["loss"]), rel=1e-6)
    keys, gp = _flatten_with_paths(got["params"])
    _, wp = _flatten_with_paths(want["params"])
    for k, g, w in zip(keys, gp, wp):
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL, err_msg=k)
    for part in ("m", "v"):
        keys, gs = _flatten_with_paths(got["state"][part])
        _, ws = _flatten_with_paths(want["state"][part])
        for k, g, w in zip(keys, gs, ws):
            tol = (BF16_STATE_RTOL if arch == "whisper-small"
                   else STATE_RTOL)
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= tol * scale, (part, k)
    assert int(got["state"]["step"]) == int(want["state"]["step"]) == 1


@pytest.fixture(scope="module")
def plain_decode():
    cfg = mc.decode_config()
    params = mc.f32_params(cfg)
    prompt, steps = mc.decode_inputs(cfg)
    with torch.no_grad():
        _, cache = api.prefill(cfg, params, {"tokens": prompt},
                               mc.DECODE_PROMPT)
        logits = []
        for tok in steps:
            lg, cache = api.decode_step(cfg, params, cache, {"token": tok})
            logits.append(lg.float().numpy())
    return logits, _np(cache)


@pytest.mark.parametrize("mesh", mc.MESHES, ids=lambda m: "x".join(map(
    str, m)))
def test_shmap_flash_decode_matches_plain_decode(ranks, plain_decode, mesh):
    """Three decode steps over the sequence-sharded cache against the
    meshless decode. The body's probabilities are cast to the bf16 cache's
    dtype before the second product, unnormalised, where the plain
    attention casts normalised ones: bf16 rounding at other points (the
    JAX package's own test holds its two routes to 5e-2)."""
    got = ranks[mesh]["decode"]
    want_logits, want_cache = plain_decode
    cfg = mc.decode_config()
    assert got["shmap_calls"] == cfg.num_layers * mc.DECODE_STEPS
    for g, w in zip(got["logits"], want_logits):
        np.testing.assert_allclose(g, w, atol=5e-2, rtol=5e-2)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    for key in ("k", "v"):
        np.testing.assert_allclose(got["cache"][key], want_cache[key],
                                   atol=2e-2, rtol=2e-2)
    for key in ("k_pos", "pos"):
        np.testing.assert_array_equal(got["cache"][key], want_cache[key])


def _jax_sorted_shmap(cfg, layer, x):
    jcfg = jreg.get_config("mixtral-8x7b").reduced().replace(
        n_experts=cfg.n_experts, capacity_factor=cfg.capacity_factor,
        moe_impl="sorted_shmap")
    p = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
         for k, v in layer.items()}
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    with jshd.use_mesh(jmake_mesh((1, 1), ("data", "model"))):
        y, aux = jax.jit(lambda p, x: jmoe.moe_block(jcfg, p, x))(p, jx)
    return np.asarray(y, np.float32), float(aux)


@pytest.mark.parametrize("mesh", mc.MESHES, ids=lambda m: "x".join(map(
    str, m)))
@pytest.mark.parametrize("cf", mc.MOE_FACTORS)
def test_sorted_shard_map_matches_einsum_sorted_and_jax(ranks, cf, mesh):
    """The local body ran (no fallback), and its outputs equal the
    meshless einsum and sorted dispatches and the JAX package's
    "sorted_shmap" on its 1x1 mesh, at the JAX test's bf16 tolerance. The
    load-balancing loss is, as in the reference's body, the mean over the
    data-parallel shards of each shard's own loss (its expert shares are
    means over the shard's tokens): on one shard the loss of the whole
    batch, on two the mean of the two halves' losses."""
    got = ranks[mesh]["moe"][cf]
    assert got["local"]
    cfg = mc.moe_config(cf)
    layer, x = mc.moe_inputs(cfg)
    jy, jaux = _jax_sorted_shmap(cfg, layer, x)
    np.testing.assert_allclose(got["y"], jy, atol=1e-3)
    shards = x.chunk(mesh[0])
    want_aux = np.mean([float(tmoe.route(cfg, layer, xs)[3])
                        for xs in shards])
    assert float(got["aux"]) == pytest.approx(want_aux, rel=1e-5)
    if mesh[0] == 1:
        assert float(got["aux"]) == pytest.approx(jaux, rel=1e-4)
    for impl in ("einsum", "sorted"):
        y, aux = tmoe.moe_block(cfg.replace(moe_impl=impl), layer, x)
        np.testing.assert_allclose(got["y"], y.float().numpy(), atol=1e-3)


@pytest.mark.parametrize("mesh", mc.MESHES, ids=lambda m: "x".join(map(
    str, m)))
def test_kernel_wrapper_runs_on_local_shards(ranks, mesh):
    """The SSD scan on sharded batch and heads, the RG-LRU scan on sharded
    batch and columns, and flash attention on sharded query heads with the
    kv heads replicated (each rank narrows them) equal the unsharded plain
    versions; a sequence-sharded input raises."""
    got = ranks[mesh]["kernels"]
    (x, dt, A, Bm, Cm), (a, b) = mc.scan_inputs()
    y, final = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    np.testing.assert_allclose(got["ssd"][0], y.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["ssd"][1], final.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert got["placements"] == ((0, 2), (0, 1))
    np.testing.assert_array_equal(got["rglru"], ops.rglru_scan(a, b).numpy())
    q, k, v = mc.attn_inputs()
    ctx = ops.flash_attention(q, k, v, q_block=16, kv_block=16)
    np.testing.assert_allclose(got["attn"], ctx.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert got["seq_raises"]


def test_checkpoint_restores_bit_equal_onto_another_mesh(ranks):
    """Saved from DTensors on (2, 2), restored with ``shardings=`` onto
    (1, 4): every leaf bit-equal and in the new mesh's placement."""
    got = ranks["checkpoint"]
    assert got["on_dst"]
    keys, saved = _flatten_with_paths(got["saved"])
    _, back = _flatten_with_paths(got["restored"])
    assert len(keys) == len(back)
    for k, s, r in zip(keys, saved, back):
        np.testing.assert_array_equal(s, r, err_msg=k)
