"""The paper's benchmark functions (Table 2) as real torch workloads, plus
ML-serving functions wrapping the model zoo.

Each FaaSProfiler-derived function keeps its compute/data character:
  nodeinfo            trivial metadata endpoint (latency-floor probe)
  primes-python       compute-bound: count primes below n (vectorized
                      division-test sieve instead of a Python loop)
  image-processing    reads an image object from the store; flip/rotate/
                      filter/grayscale/resize as tensor ops
  sentiment-analysis  tiny transformer forward (reduced qwen3) + 2-class head
  json-loads          I/O-bound: reads a 1000x3 coordinate object, averages

``real_fn`` callables execute on ``device`` (the CUDA card unless the caller
asks for the CPU) and return only when their device work is done
(``torch.cuda.synchronize`` on the card, where the JAX package blocks until
ready), so the ExecutionModel that measures them once times the work, not
its launch.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.types import FunctionSpec, SLO
from repro_torch.device import DeviceLike, generator, resolve


def _done(x: torch.Tensor) -> torch.Tensor:
    """``x`` once the device has finished computing it."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


# ---------------------------------------------------------------------------
# real torch bodies
# ---------------------------------------------------------------------------


def _nodeinfo_body(device: torch.device) -> torch.Tensor:
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    return torch.tensor([count, 1, 0], dtype=torch.int32, device=device)


def _primes_body(n: int = 1_000_000, device: DeviceLike = "cpu"
                 ) -> torch.Tensor:
    """Division-test sieve: an x in [2, n) is composite when a divisor d
    in [2, sqrt(n)] other than x divides it. The divisors go in blocks of
    16, so no (divisors, n) matrix is held at once (the JAX package's jit
    fuses that matrix away; eager torch would hold it)."""
    xs = torch.arange(2, n, dtype=torch.int32, device=device)
    limit = int(np.sqrt(n)) + 1
    divs = torch.arange(2, limit, dtype=torch.int32, device=device)
    composite = torch.zeros_like(xs, dtype=torch.bool)
    for lo in range(0, divs.numel(), 16):
        d = divs[lo:lo + 16, None]
        composite |= ((xs[None, :] % d == 0) & (xs[None, :] != d)).any(0)
    return (~composite).sum()


def _box_blur3(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean filter with zero padding (``convolve2d(x, ones((3, 3)) /
    9, mode="same")`` in the JAX package) as nine shifted adds: an f32
    convolution would run through cuDNN in TF32 on the card."""
    h, w = x.shape
    padded = F.pad(x, (1, 1, 1, 1))
    weight = torch.tensor(1.0 / 9.0, dtype=torch.float32, device=x.device)
    out = torch.zeros_like(x)
    for di in range(3):
        for dj in range(3):
            out = out + padded[di:di + h, dj:dj + w] * weight
    return out


def _half_resize(x: torch.Tensor) -> torch.Tensor:
    """Bilinear resize to half of each side, antialiased as
    ``jax.image.resize(..., "bilinear")`` is when it shrinks."""
    h, w = x.shape
    return F.interpolate(x[None, None], size=(h // 2, w // 2),
                         mode="bilinear", align_corners=False,
                         antialias=True)[0, 0]


def _image_body(img: torch.Tensor) -> torch.Tensor:
    """flip, rotate, filter(blur), grayscale, resize — paper Table 2."""
    img = img.to(torch.float32)
    rotated = torch.rot90(img.flip(1), 1, (0, 1))
    return _half_resize(_box_blur3(rotated.mean(-1))).mean()


def _json_loads_body(coords: torch.Tensor) -> torch.Tensor:
    return coords.mean(0)


def _sentiment_fns(device: torch.device, params: Optional[Dict] = None):
    """The sentiment body over the reduced 2-layer qwen3-0.6b: random bf16
    parameters from seed 0 on ``device``, or ``params`` (for instance the
    JAX package's, carried across by ``models.convert.params_from_numpy``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_api as api
    from repro_torch.models import transformer as tfm
    cfg = get_config("qwen3-0.6b").reduced().replace(num_layers=2)
    if params is None:
        params = api.init_params(cfg, generator(0, device), device)

    def body(token_ids: torch.Tensor) -> torch.Tensor:
        emb = params["embed"][token_ids[None]]
        h, _, _ = tfm.forward_hidden(cfg, params, emb)
        return torch.softmax(h[:, -1, :2], dim=-1)

    return body


# ---------------------------------------------------------------------------
# FunctionSpecs (analytic demands sized from the paper's workloads)
# ---------------------------------------------------------------------------


def paper_functions(image_key: str = "images/sample.jpg",
                    json_key: str = "json/coords.json",
                    device: DeviceLike = None) -> Dict[str, FunctionSpec]:
    dev = resolve(device)
    sentiment = _sentiment_fns(dev)
    tokens = torch.arange(64, dtype=torch.int64, device=dev)
    return {
        "nodeinfo": FunctionSpec(
            name="nodeinfo", flops=1e6, memory_mb=128, runtime="nodejs",
            real_fn=lambda *a: _done(_nodeinfo_body(dev)),
            slo=SLO(2.0)),
        "primes-python": FunctionSpec(
            name="primes-python", flops=6e9, memory_mb=256,
            real_fn=lambda *a: _done(_primes_body(400_000, dev)),
            slo=SLO(20.0)),
        "image-processing": FunctionSpec(
            name="image-processing", flops=2e8, read_bytes=2e6,
            memory_mb=256, data_objects=(image_key,),
            real_fn=lambda img=None, *a: _done(_image_body(
                img if img is not None
                else torch.ones((256, 256, 3), device=dev))),
            slo=SLO(5.0)),
        "sentiment-analysis": FunctionSpec(
            name="sentiment-analysis", flops=8e8, memory_mb=512,
            real_fn=lambda *a: _done(sentiment(tokens)),
            slo=SLO(10.0)),
        "JSON-loads": FunctionSpec(
            name="JSON-loads", flops=1e7, read_bytes=1e5, memory_mb=256,
            data_objects=(json_key,),
            real_fn=lambda coords=None, *a: _done(_json_loads_body(
                coords if coords is not None
                else torch.ones((1000, 3), device=dev))),
            slo=SLO(7.0)),
    }


def serving_function(arch: str, kind: str = "decode",
                     tokens_per_req: int = 64) -> FunctionSpec:
    """An ML-serving 'function': one batched decode/prefill call of `arch`.

    FLOPs demand comes from the analytic model (2*N_active per token served
    for decode); weights are a data object whose locality drives cold-start
    and placement (§5.1.4 adapted to weight placement).
    """
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    n_active = cfg.n_active_params()
    flops = 2.0 * n_active * tokens_per_req
    weight_bytes = 2.0 * cfg.n_params()
    return FunctionSpec(
        name=f"serve-{arch}", flops=flops, read_bytes=0.0,
        memory_mb=int(weight_bytes / 1e6) + 256,
        data_objects=(f"weights/{arch}",), arch=arch, kind="serve",
        slo=SLO(p90_response_s=2.0))


def seed_object_stores(placement, image_key="images/sample.jpg",
                       json_key="json/coords.json", location="local",
                       device: DeviceLike = None):
    """The image and coordinate objects, made from seed 0 with numpy, as
    tensors on ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve(device)
    rng = np.random.default_rng(0)
    if location not in placement.stores:
        placement.add_store(location)
    st = placement.stores[location]
    st.put(image_key, 2e6, torch.from_numpy(
        rng.integers(0, 255, (256, 256, 3)).astype(np.uint8)).to(dev))
    st.put(json_key, 1e5, torch.from_numpy(
        rng.normal(size=(1000, 3)).astype(np.float32)).to(dev))
