"""The port's training path against the JAX package's: ``loss_fn`` and its
gradients for the reduced configs of qwen3-0.6b, mixtral-8x7b,
recurrentgemma-9b, mamba2-2.7b, phi-3-vision-4.2b and whisper-small (the
JAX package's own initialised parameters carried across by
``params_from_numpy``, the same ``TokenStream`` batches:
tests/train_cases.py), the AdamW update (``train/optimizer.py``) on the same
inputs, the remat policies, the kernel entry points' autograd guard, and the
launchers' fault-tolerance loop. The training steps themselves are in
tests/test_torch_train_steps.py.

Tolerances:

* f32 loss: 2e-5 rel; f32 gradients: 2e-5 of the leaf's largest reference
  value, abs (only summation order differs).
* bf16 loss: 2**-7 rel; bf16 gradients: 2**-4 of the leaf's largest
  reference value, abs: both frameworks round every op to bf16 at different
  places, through the forward pass and back (the forward's logits keep
  2**-5, tests/test_torch_model.py; the backward doubles the roundings).
* The AdamW update on the same inputs: f32 within 4 f32 ulps of the
  reference's value (XLA's and torch's ``pow`` may round differently) plus
  1e-12; bf16 within one bf16 ulp; lr and grad norm 1e-6 rel.

whisper-small trains in bf16 only: the JAX package's ``encode`` cannot take
f32 parameters (ROADMAP.md, Queue 3).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import train_cases as tc  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import model_api as japi  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenStream  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model_api as tapi  # noqa: E402
from repro_torch.models import params as tpm  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from train_cases import jax_params, one_torch_thread  # noqa: E402,F401


# ------------------------------------------------------------ loss + grad --
@pytest.mark.parametrize("arch,dtype", tc.CASES)
def test_loss_and_grads_match_reference(jax_params, arch, dtype):
    jcfg, jp, tcfg, tp = tc.setup(jax_params, arch, dtype)
    b = tc.batch(jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, x: japi.loss_fn(jcfg, p, x), has_aux=True))(
            jp, tc.jax_batch(b))
    tl, tm, tg = tts._value_and_grad(tcfg, tp, tc.torch_batch(b))
    rel = 2e-5 if dtype == "f32" else 2 ** -7
    assert float(tl) == pytest.approx(float(jl), rel=rel)
    assert float(tm["ce"]) == pytest.approx(float(jm["ce"]), rel=rel)
    assert float(tm["aux"]) == pytest.approx(float(jm["aux"]), rel=rel,
                                             abs=1e-6)
    if jcfg.family == "moe":
        assert float(jm["aux"]) > 0
    tc.close_tree(tg, jg, tc.within(2e-5 if dtype == "f32" else 2 ** -4))


# --------------------------------------------------------------- remat -----
@pytest.mark.parametrize("arch", tc.ARCHS)
def test_remat_policies_give_bit_equal_losses_and_grads(jax_params, arch):
    results = []
    for policy, on in (("none", False), ("none", True), ("dots", True),
                       ("full", True)):
        _, _, tcfg, tp = tc.setup(jax_params, arch, "bf16", remat=policy)
        b = tc.torch_batch(tc.batch(tcfg))
        leaves = [p.requires_grad_() for p in tpm.tree_leaves(tp)]
        loss, _ = tapi.loss_fn(tcfg, tp, b, remat=on)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        results.append((loss.detach(), grads))
    l0, g0 = results[0]
    for l1, g1 in results[1:]:
        assert torch.equal(l0, l1)
        for a, c in zip(g0, g1):
            assert (a is None and c is None) or torch.equal(a, c)


def _backward_products(tcfg, tp, b):
    """(mm, bmm) calls made while the backward pass of ``loss_fn`` (with
    remat) runs: what the forward did not keep is recomputed there."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    leaves = [p.requires_grad_() for p in tpm.tree_leaves(tp)]
    loss, _ = tapi.loss_fn(tcfg, tp, b, remat=True)
    with Count() as count:
        torch.autograd.grad(loss, leaves, allow_unused=True)
    return count.n["mm"], count.n["bmm"]


def test_remat_policies_recompute_what_they_do_not_save(jax_params):
    """"dots" keeps the unbatched products (mm) and recomputes the
    attention's batched ones (bmm); "full" recomputes both; "none"
    neither."""
    n = {}
    for policy in ("none", "dots", "full"):
        _, _, tcfg, tp = tc.setup(jax_params, "qwen3-0.6b", "bf16",
                                remat=policy)
        n[policy] = _backward_products(tcfg, tp,
                                       tc.torch_batch(tc.batch(tcfg)))
    assert n["none"][0] == n["dots"][0] < n["full"][0], n
    assert n["none"][1] < n["dots"][1] == n["full"][1], n


# ----------------------------------------------------------- optimizer -----
def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    # gradients over eight decades, zeros and one element at exactly eps
    g = rng.normal(size=(5, 7)) * 10.0 ** rng.integers(-9, 0, (5, 7))
    g[0, :3] = 0.0
    g[1, 0] = 1e-8
    return {"a": {"w": rng.normal(size=(5, 7)).astype(dtype)},
            "b": (rng.normal(size=(11,)) * 0.1).astype(dtype),
            "g": {"a": {"w": g.astype(dtype)},
                  "b": (rng.normal(size=(11,)) * 1e-3).astype(dtype)}}


def _spec(tree):
    from repro.models import params as jpm
    return jax.tree_util.tree_map(lambda a: jpm.Spec(a.shape, (None,) * a.ndim,
                                                     "zeros"), tree)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_updates_matches_reference(dtype, compress):
    """Three updates from the same parameters and the same gradients: the
    new parameters, m, v (and ef) and the metrics."""
    jdt, tdt = tc.DTYPES[dtype]
    t = _tree(1)
    params = {"a": t["a"], "b": t["b"]}
    oc = dict(tc.OC, compress_grads=compress)
    jo, to = jopt.OptConfig(**oc), topt.OptConfig(**oc)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    tp = tpm.tree_map(lambda a: torch.from_numpy(a).to(tdt), params)
    js = jopt.init_state(jo, _spec(params))
    ts = topt.init_state(to, tpm.tree_map(
        lambda a: tpm.Spec(a.shape, (None,) * a.ndim), params), "cpu")
    for i in range(3):
        g = _tree(10 + i)["g"]
        jp, js, jm = jopt.apply_updates(
            jo, jp, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), g),
            js)
        tp, ts, tm = topt.apply_updates(
            to, tp, tpm.tree_map(lambda a: torch.from_numpy(a).to(tdt), g),
            ts)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        for k in ("lr", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)

        def f32_ulps(g_, w):
            lim = 4 * np.spacing(np.abs(w).astype(np.float32)) + 1e-12
            return None if (np.abs(g_ - w) <= lim).all() else \
                f"max err {np.abs(g_ - w).max()}"

        def one_bf16_ulp(g_, w):
            ok = np.abs(g_ - w) <= tc.bf16_ulp(w)
            return None if ok.all() else f"max err {np.abs(g_ - w).max()}"

        tc.close_tree(tp, jp, f32_ulps if dtype == "f32" else one_bf16_ulp)
        for k in ("m", "v") + (("ef",) if compress else ()):
            tc.close_tree(ts[k], js[k], f32_ulps)


def test_schedule_matches_reference():
    oc = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    steps = [0, 1, 5, 9, 10, 11, 40, 99, 100, 101, 250]
    got = topt.schedule(topt.OptConfig(**oc),
                        torch.tensor(steps, dtype=torch.int32))
    want = jopt.schedule(jopt.OptConfig(**oc), jnp.asarray(steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert float(got[-1]) == pytest.approx(3e-4, rel=1e-6)


def test_compress_decompress_matches_reference_and_rounds_half_to_even():
    # scale = 127 / 127 = 1: the quotients 0.5, 1.5, 2.5, -2.5 are exact
    # halves, which round to 0, 2, 2, -2 (half to even)
    g = np.array([127.0, 0.5, 1.5, 2.5, -2.5, 3.2, -0.4], np.float32)
    ef = np.zeros_like(g)
    got, got_ef = topt.compress_decompress(torch.from_numpy(g),
                                           torch.from_numpy(ef))
    want, want_ef = jopt.compress_decompress(jnp.asarray(g), jnp.asarray(ef))
    assert got.tolist() == [127.0, 0.0, 2.0, 2.0, -2.0, 3.0, 0.0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_ef.numpy(), np.asarray(want_ef))
    rng = np.random.default_rng(3)
    g = rng.normal(size=300).astype(np.float32)
    ef = (rng.normal(size=300) * 1e-2).astype(np.float32)
    got, got_ef = topt.compress_decompress(torch.from_numpy(g).bfloat16(),
                                           torch.from_numpy(ef))
    want, want_ef = jopt.compress_decompress(jnp.asarray(g, jnp.bfloat16),
                                             jnp.asarray(ef))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_ef.numpy(), np.asarray(want_ef))


def test_global_norm_matches_reference():
    t = _tree(5)
    got = topt.global_norm(tpm.tree_map(torch.from_numpy, t))
    want = jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, t))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("compress", [False, True])
def test_state_shardings_place_the_zero_axis(compress):
    """ZeRO-1: m and v of every leaf on the reference's specs, the data axis
    on the largest replicated dim (16x16 mesh, no devices needed); the
    step replicated; ef (with int8 compression) as the parameters."""
    from jax.sharding import AbstractMesh
    from repro.models import params as jpm
    from repro_torch import sharding as shd

    mesh = shd.AbstractMesh((16, 16), ("data", "model"))
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    oc = topt.OptConfig(compress_grads=compress)
    cfg = treg.get_config("qwen3-0.6b")
    got = topt.state_shardings(oc, tapi.model_specs(cfg), mesh)
    want = jopt.state_specs(japi.model_specs(jreg.get_config("qwen3-0.6b")))
    assert sorted(got) == (["ef", "m", "step", "v"] if compress
                           else ["m", "step", "v"])
    for part in got:
        if part == "step":
            assert got[part].spec == ()
            continue
        g = tpm.tree_leaves(got[part])
        w = [tuple(a for a in s) for s in jax.tree_util.tree_leaves(
            jpm.pspecs(want[part], jmesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
        for gs, ws in zip(g, w):
            while ws and ws[-1] is None:
                ws = ws[:-1]
            assert gs.spec == ws
        if part in ("m", "v"):
            assert any("data" in (s.spec or ()) for s in g)


# ------------------------------------------------------- autograd guard ----
def _guard_cases():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 4, 32, generator=g)
    kv = torch.randn(1, 16, 2, 32, generator=g)
    a = torch.rand(1, 16, 8, generator=g)
    x = torch.randn(1, 16, 2, 8, generator=g)
    bm = torch.randn(1, 16, 1, 4, generator=g)
    return {
        "flash_attention": (lambda q, k, v: kops.flash_attention(
            q, k, v, q_block=16, kv_block=16), (q, kv, kv.clone())),
        "decode_attention": (lambda q, k, v: kops.decode_attention(
            q, k, v, torch.tensor([16]), splits=1, kv_block=16),
            (q[:, 0], kv, kv.clone())),
        "ssd_scan": (lambda x, dt, A, B, C: kops.ssd_scan(
            x, dt, A, B, C, chunk=8),
            (x, torch.rand(1, 16, 2, generator=g), -torch.rand(2, generator=g),
             bm, bm.clone())),
        "rglru_scan": (lambda a, b: kops.rglru_scan(a, b), (a, a.clone())),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "ssd_scan", "rglru_scan"])
def test_kernel_entry_points_raise_under_autograd(name):
    fn, args = _guard_cases()[name]
    fn(*args)                                   # no input requires grad
    for i in range(len(args)):
        live = [t.clone().requires_grad_(j == i) for j, t in enumerate(args)]
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            fn(*live)
        with torch.no_grad():
            fn(*live)
        with torch.inference_mode():
            fn(*args)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
def test_a_train_step_with_the_kernel_route_raises(jax_params, arch):
    _, _, tcfg, tp = tc.setup(jax_params, arch, "f32", use_pallas=True)
    to = topt.OptConfig(**tc.OC)
    step = tts.make_train_step(tcfg, to)
    with pytest.raises(RuntimeError, match="has no backward"):
        step(tp, topt.init_state(to, tapi.model_specs(tcfg), "cpu"),
             tc.torch_batch(tc.batch(tcfg)))
    # the inference steps run the kernel route without autograd
    tok = torch.randint(1, tcfg.vocab_size, (2, 16))
    tpm.tree_map(lambda p: p.requires_grad_(), tp)
    logits, cache = tts.make_prefill_step(tcfg, 24)(tp, {"tokens": tok})
    assert not logits.requires_grad
    logits, _ = tts.make_serve_step(tcfg)(tp, cache,
                                          {"token": tok[:, :1]})
    assert logits.shape[:2] == (2, 1)


def test_default_microbatches_matches_reference():
    from repro.configs.base import TRAIN_4K as JT
    from repro_torch.configs.base import TRAIN_4K as TT
    for arch in tc.ARCHS:
        for chips in (1, 8, 256):
            assert tts.default_microbatches(
                treg.get_config(arch), TT, chips) == jts.default_microbatches(
                    jreg.get_config(arch), JT, chips)


# ------------------------------------------------------------ launcher -----
def test_train_loop_resumes_at_the_saved_step(tmp_path):
    """Four steps without a break against two, a restart from the step-2
    checkpoint (restored into fresh tensors) and two more: the same
    losses, bit for bit, under deterministic algorithms."""
    cfg = treg.get_config("qwen3-0.6b").reduced()
    oc = topt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    stream = TokenStream(DataConfig(cfg.vocab_size, 16, 2, mean_doc_len=8))

    def fresh():
        return (tapi.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu"),
                topt.init_state(oc, tapi.model_specs(cfg), "cpu"))

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        _, _, whole = tlaunch.train_loop(cfg, oc, *fresh(), stream, 4,
                                         log=lambda s: None)
        ck = Checkpointer(str(tmp_path), async_save=True)
        tlaunch.train_loop(cfg, oc, *fresh(), stream, 2, ck=ck,
                           ckpt_every=2, log=lambda s: None)
        params, state, start = tlaunch.restore_latest(ck, *fresh())
        assert start == 2 and int(state["step"]) == 2
        _, _, resumed = tlaunch.train_loop(cfg, oc, params, state, stream, 4,
                                           start_step=start,
                                           log=lambda s: None)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert [r["step"] for r in resumed] == [3, 4]
    assert [r["loss"] for r in resumed] == [r["loss"] for r in whole[2:]]
    assert whole[-1]["loss"] < whole[0]["loss"]


def test_launcher_restores_the_latest_checkpoint(tmp_path, capsys):
    args = ["--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    assert tlaunch.main(args + ["--steps", "4"]) == 0
    assert Checkpointer(str(tmp_path)).all_steps() == [2, 4]
    out = capsys.readouterr().out
    assert "restored" not in out and "step    3" in out
    assert tlaunch.main(args + ["--steps", "5"]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint step 4" in out
    assert "step    4" in out and "step    3" not in out
    assert Checkpointer(str(tmp_path)).extra(4) == {
        "arch": "qwen3-0.6b-reduced"}


def test_launcher_names_the_missing_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    assert tlaunch.main(["--steps", "1"]) == 2
    assert "no CUDA card" in capsys.readouterr().err


def test_quickstart_trains_then_serves(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1]) for line in out.splitlines()
              if "loss=" in line]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert "served: [8, 8, 8, 8, 8, 8]" in out
