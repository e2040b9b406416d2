"""Shared cases of the port's training tests (tests/test_torch_train.py
and tests/test_torch_train_steps.py): the reduced configs, the JAX package's
initial parameters carried across by ``params_from_numpy``, one
``TokenStream`` batch per seed for both packages, and the leaf-by-leaf
comparison of a port tree with a JAX tree; the three-step runs of
``make_train_step`` in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.models import model_api as japi
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import registry as treg
from repro_torch.launch import train as tlaunch
from repro_torch.models import model_api as tapi
from repro_torch.models import params as tpm
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

ARCHS = ["qwen3-0.6b", "mixtral-8x7b", "recurrentgemma-9b", "mamba2-2.7b",
         "phi-3-vision-4.2b", "whisper-small"]
CASES = [(a, d) for a in ARCHS for d in ("f32", "bf16")
         if not (a == "whisper-small" and d == "f32")]
BATCH, SEQ = 2, 128
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
OC = dict(lr=1e-3, warmup_steps=2, total_steps=6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test workers at once; torch's tiny ops on a
    thread pool each spin against the others' (the quickstart took 98 s
    instead of 3 beside five busy processes). One thread a module keeps its
    torch work as fast as alone (a test module imports this fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's initial parameters of each reduced config (a
    test module imports this fixture)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = japi.init_params(jreg.get_config(arch).reduced(),
                                           jax.random.PRNGKey(0))
        return cache[arch]

    return get


def batch(cfg, seed=0):
    """One ``TokenStream`` batch (EOS-masked positions included) with the
    VLM's image embeddings or the encoder's frames drawn from ``seed``, as
    numpy (bf16 values held in f32)."""
    text = SEQ - cfg.n_img_tokens
    b = dict(JTokenStream(JDataConfig(cfg.vocab_size, text, BATCH,
                                      mean_doc_len=24)).batch(seed))
    rng = np.random.default_rng(seed)
    for key, n in (("image_embeds", cfg.n_img_tokens),
                   ("frames", cfg.n_enc_frames)):
        if n:
            x = rng.normal(size=(BATCH, n, cfg.d_model)) * 0.02
            b[key] = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return b


def jax_batch(b):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in ("image_embeds", "frames")
                           else v.dtype) for k, v in b.items()}


def torch_batch(b):
    out = tlaunch.batch_to_device(
        {k: v for k, v in b.items() if k not in ("image_embeds", "frames")},
        torch.device("cpu"))
    for k in ("image_embeds", "frames"):
        if k in b:
            out[k] = torch.from_numpy(b[k]).to(torch.bfloat16)
    return out


def setup(jax_params, arch, dtype, **kw):
    jdt, tdt = DTYPES[dtype]
    jcfg = jreg.get_config(arch).reduced().replace(**kw)
    tcfg = treg.get_config(arch).reduced().replace(**kw)
    jp0 = jax_params(arch)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jdt), jp0)
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp0),
                           dtype=tdt, device="cpu")
    return jcfg, jp, tcfg, tp


def f32(x):
    return (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def bf16_ulp(x):
    """One bf16 ulp of each value (8 significant bits)."""
    a = np.abs(x).astype(np.float64)
    e = np.floor(np.log2(np.where(a > 0, a, 2.0 ** -126)))
    return 2.0 ** (np.maximum(e, -126) - 7)


def close_tree(got, want, tol):
    """Leaf by leaf, ``tol(got, want)`` -> message or None."""
    jleaves = jax.tree_util.tree_leaves_with_path(want)
    tleaves = tpm.tree_leaves(got)
    assert len(jleaves) == len(tleaves)
    for (path, w), g in zip(jleaves, tleaves):
        w, g = f32(w), f32(g)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        bad = tol(g, w)
        assert bad is None, f"{jax.tree_util.keystr(path)}: {bad}"


def within(scale):
    def tol(g, w):
        lim = scale * float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        return None if err <= lim else f"max err {err} > {lim}"
    return tol


# ------------------------------------------------------------ train steps --
# (microbatches, compress_grads) of each arch's three-step runs
# (tests/test_torch_train_steps.py in f32, test_torch_train_steps_bf16.py):
# in f32 every arch runs two of the four, qwen3-0.6b all four; in bf16 every
# arch runs two microbatches with compression, qwen3-0.6b also one without
STEP_MODES = {"f32": [(1, False), (2, True)], "bf16": [(2, True)]}
QWEN_MODES = {"f32": [(2, False), (1, True)], "bf16": [(1, False)]}


def step_cases(dtype):
    return [(a, m, c) for a, d in CASES if d == dtype
            for m, c in STEP_MODES[dtype]
            + (QWEN_MODES[dtype] if a == "qwen3-0.6b" else [])]


def lr_sum(oc, steps):
    return sum(float(topt.schedule(oc, torch.tensor(s)))
               for s in range(1, steps + 1))


def check_params(got, want, dtype, lrs, steps):
    """Every element within the hard bound; the share of elements within
    the tight one, counted over the whole tree; ``lrs`` is the sum of the
    learning rates of the ``steps`` steps taken."""
    close = total = 0
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            tpm.tree_leaves(got)):
        w, g = f32(w), f32(g)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        err = np.abs(g - w)
        if dtype == "f32":
            bound = 2e-5 * np.abs(w) + 2.1 * lrs
            tight = 1e-6 * np.abs(w) + 1e-3 * lrs
        else:
            bound = bf16_ulp(w) + 2.1 * lrs
            tight = bf16_ulp(w) + 0.05 * lrs
        assert (err <= bound).all(), \
            f"{jax.tree_util.keystr(path)}: max err {err.max()}"
        close += int((err <= tight).sum())
        total += err.size
    share = 0.999 if dtype == "f32" else (0.98 if steps == 1 else 0.9)
    assert close / total >= share, f"{close / total:.5f} < {share} close"


def run_steps(jax_params, arch, dtype, mb, compress):
    """Three steps of ``make_train_step`` in both packages on batches 0-2,
    checked after the first and the third (the tolerances of
    tests/test_torch_train_steps.py's docstring)."""
    jcfg, jp, tcfg, tp = setup(jax_params, arch, dtype)
    oc = dict(OC, compress_grads=compress)
    jo, to = jopt.OptConfig(**oc), topt.OptConfig(**oc)
    js = jopt.init_state(jo, japi.model_specs(jcfg))
    ts = topt.init_state(to, tapi.model_specs(tcfg), "cpu")
    jstep = jax.jit(jts.make_train_step(jcfg, jo, mb))
    tstep = tts.make_train_step(tcfg, to, mb)
    rel = {"loss": 2e-5, "grad_norm": 5e-4 if compress else 2e-5}
    if dtype == "bf16":
        rel = {"loss": 2 ** -6, "grad_norm": 2 ** -5}
    for i in range(3):
        b = batch(jcfg, seed=i)
        jp, js, jm = jstep(jp, js, jax_batch(b))
        tp, ts, tm = tstep(tp, ts, torch_batch(b))
        for k in ("loss", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]),
                                                 rel=rel[k]), k
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        if i in (0, 2):
            check_params(tp, jp, dtype, lr_sum(to, i + 1), i + 1)
    assert tp["final_norm"].dtype == DTYPES[dtype][1]
    assert int(ts["step"]) == 3 and ("ef" in ts) == compress
