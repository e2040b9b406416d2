"""The port's paper-function bodies (``repro_torch.core.functions``)
against the JAX package's on the same numpy-seeded inputs, on the CPU.

Tolerances: the primes count and nodeinfo are exact; the image steps and
the JSON mean are float32 computations whose sums run in another order
(the box filter as nine shifted adds against XLA's convolution, the
antialiased resize against ``jax.image.resize``): rtol 1e-5, atol 1e-4 on
pixel values up to 255. Sentiment runs the reduced 2-layer qwen3-0.6b in
bf16 with the JAX package's own parameters carried across
(``params_from_numpy``); both frameworks round every op to bf16 at
different places, so its two softmax outputs (in [0, 1]) take 2**-5
absolute, as tests/test_torch_model.py's bf16 logits do."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import functions as jf  # noqa: E402
from repro.core.data_placement import DataPlacementManager as JPlacement  # noqa: E402,E501
from repro.core.platform import ExecutionModel as JExec  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import model_api as japi  # noqa: E402
from repro_torch.core import functions as tf  # noqa: E402
from repro_torch.core.data_placement import DataPlacementManager as TPlacement  # noqa: E402,E501
from repro_torch.core.platform import ExecutionModel as TExec  # noqa: E402
from repro_torch.core import profiles as tprofiles  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-4)
CPU = torch.device("cpu")


def _image(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 255, (256, 256, 3)).astype(np.uint8)


def test_nodeinfo_and_primes_are_exact():
    np.testing.assert_array_equal(tf._nodeinfo_body(CPU).numpy(),
                                  np.asarray(jf._nodeinfo_body()))
    for n in (1000, 400_000):
        assert int(tf._primes_body(n, "cpu")) == int(jf._primes_body(n))
    assert int(tf._primes_body(1000, "cpu")) == 168


def test_image_steps_match_jax():
    gray = _image(1).astype(np.float32).mean(-1)
    want = jax.scipy.signal.convolve2d(jnp.asarray(gray),
                                       jnp.ones((3, 3), jnp.float32) / 9.0,
                                       mode="same")
    got = tf._box_blur3(torch.from_numpy(gray))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    want = jax.image.resize(jnp.asarray(gray), (128, 128), "bilinear")
    got = tf._half_resize(torch.from_numpy(gray))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # odd sides halve as jax.image.resize does
    odd = gray[:255, :201]
    want = jax.image.resize(jnp.asarray(odd), (127, 100), "bilinear")
    np.testing.assert_allclose(
        tf._half_resize(torch.from_numpy(odd)).numpy(), np.asarray(want),
        **F32)


@pytest.mark.parametrize("seed", [0, 1])
def test_image_and_json_bodies_match_jax(seed):
    img = _image(seed)
    np.testing.assert_allclose(
        float(tf._image_body(torch.from_numpy(img))),
        float(jf._image_body(jnp.asarray(img))), **F32)
    coords = np.random.default_rng(seed).normal(
        size=(1000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tf._json_loads_body(torch.from_numpy(coords)).numpy(),
        np.asarray(jf._json_loads_body(jnp.asarray(coords))), **F32)


def test_sentiment_body_through_converted_parameters():
    jcfg = jget("qwen3-0.6b").reduced().replace(num_layers=2)
    tcfg = tget("qwen3-0.6b").reduced().replace(num_layers=2)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    want = np.asarray(jf._sentiment_fns()(jnp.arange(64, dtype=jnp.int32)),
                      np.float32)
    got = tf._sentiment_fns(CPU, tparams)(torch.arange(64))
    assert got.shape == want.shape == (1, 2)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -5)


def test_seeded_objects_match_and_bodies_run_on_the_cpu():
    jp, tp = JPlacement(), TPlacement()
    jf.seed_object_stores(jp, location="cloud-cluster")
    tf.seed_object_stores(tp, location="cloud-cluster", device="cpu")
    for key in ("images/sample.jpg", "json/coords.json"):
        jobj = jp.stores["cloud-cluster"]
        tobj = tp.stores["cloud-cluster"]
        assert jobj.objects[key] == tobj.objects[key]
        want = np.asarray(jobj.payloads[key])
        got = tobj.payloads[key].numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    fns = tf.paper_functions(device="cpu")
    jfns = jf.paper_functions()
    assert list(fns) == list(jfns)
    img = tp.stores["cloud-cluster"].payloads["images/sample.jpg"]
    for name, fn in fns.items():
        assert dataclasses.asdict(fn.replace(real_fn=None)) == \
            dataclasses.asdict(jfns[name].replace(real_fn=None))
        out = fn.real_fn(img) if name == "image-processing" else fn.real_fn()
        assert torch.isfinite(torch.as_tensor(out, dtype=torch.float32)
                              ).all()
    # the execution model times a finished body and scales it
    prof = tprofiles.PAPER_PLATFORMS["edge-cluster"]
    secs = TExec().exec_seconds(fns["JSON-loads"], prof)
    assert secs > 0
    assert JExec().exec_seconds(jfns["JSON-loads"].replace(real_fn=None),
                                prof) == TExec().exec_seconds(
        fns["JSON-loads"].replace(real_fn=None), prof)


def test_serving_function_matches():
    for arch in ("qwen3-0.6b", "mamba2-2.7b", "recurrentgemma-9b"):
        assert dataclasses.asdict(tf.serving_function(arch)) == \
            dataclasses.asdict(jf.serving_function(arch))


def test_failing_body_raises():
    """A body that fails is an error, not a silent fall back to the
    analytic flops model (the JAX package's ExecutionModel swallows it)."""
    def broken(*_):
        raise RuntimeError("device path broken")
    fn = tf.paper_functions(device="cpu")["nodeinfo"].replace(real_fn=broken)
    prof = tprofiles.PAPER_PLATFORMS["edge-cluster"]
    with pytest.raises(RuntimeError, match="device path broken"):
        TExec().exec_seconds(fn, prof)
