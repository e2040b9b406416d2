#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths once on one NVIDIA card.

    python3 chip_smoke.py

Three models are served at full width through ``repro_torch.serving.engine``,
one after another (each one's weights are freed before the next loads):

* qwen3-0.6b (dense): prefill attention through the flash attention kernel
  (``src/repro_torch/csrc/flash_attention.cu``, K3) at head_dim 128;
* mamba2-2.7b (SSM): prefill through the SSD chunked scan kernel
  (``csrc/ssd_scan.cu``, K5);
* recurrentgemma-9b (hybrid): prefill through the RG-LRU scan kernel
  (``csrc/rglru_scan.cu``, K6) and local attention through K3 at head_dim
  256.

Phases, each printing its numbers on lines of its own:

  1. the card's name and power limit, as nvidia-smi gives them;
  2. build the three kernel sources from the checkout, one nvcc each, all
     started together; print the seconds and ptxas's registers and spills
     per kernel instance;
  3. hold every kernel against its plain PyTorch version on the cases of
     tests/test_kernels.py and at the serving paths' shapes, each tolerance
     printed beside the output's mean |value|;
  4. time every kernel at its path's full-width shape with S=1024 beside
     its plain version, its bound on the card and, where one PyTorch call
     computes the same function, that call (SDPA for K3: a yardstick the
     port never calls);
  5. per model: serve 16 requests (prompts of 64-1000 tokens, 32 new tokens
     each) at full width, bf16, random weights from seed 0, batch 4,
     context 1024, with every kernel's launch count set to 0 just before
     and read just after, and each kernel's launches per prefill asserted;
  6. per model: hold the prefill's last-token logits through the kernels
     against the plain route and an f32 run of the same weights;
  7. print one line listing every kernel, then the result line.

Any failed phase raises, so the script exits non-zero and prints no result
line. Without a visible card it exits non-zero at once.
"""
from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEV = "cuda"
MODELS = ("qwen3-0.6b", "mamba2-2.7b", "recurrentgemma-9b")
PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
# (atol, rtol) of flash attention against its plain version. Both compute
# in f32 and round the output once to the input dtype, so they differ by
# the order of f32 sums and, in bf16, by at most one rounding of the output:
# one bf16 step, 2**-7 of the value or less. f32 keeps tests/test_kernels.py's
# 2e-5. bf16 takes rtol 2**-7 and atol 2e-4, well under a typical |out|
# (about 1e-2 at S=1024 with these inputs, 5e-3 at D=256 under a 2048
# window); test_kernels.py's bf16 2e-2 would pass a kernel that is wrong by
# a whole typical value.
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-4, 2 ** -7)}
# The scans' tolerances scale with the output's mean |value| m: atol =
# frac * m. SSD scan: the plain f32 chunked scan lies 3.6e-5 from a float64
# one at full width, where m is 3.1 (1.2e-5 of m), so f32 takes 1e-4 * m and
# rtol 1e-5; bf16 y takes 1e-3 * m and rtol 2**-7 (one bf16 rounding of the
# same f32 value); the final state is f32 in both. RG-LRU scan (f32): the
# kernel chains 8 segments of the sequence; emulated in f32 that lies 3.8e-6
# from the sequential scan at S=1024, W=4096, where m is 2.5 (1.5e-6 of m):
# 2e-5 * m and rtol 1e-5.
SCALED_TOL = {"ssd_f32": (1e-4, 1e-5), "ssd_bf16": (1e-3, 2 ** -7),
              "rglru": (2e-5, 1e-5)}
FLASH_CASES = [                   # tests/test_kernels.py:20-49, + ragged
    # (b, s, h, kh, d, q_block, kv_block, causal, window)
    (1, 128, 4, 4, 32, 64, 64, True, None),
    (2, 256, 8, 2, 64, 64, 128, True, None),
    (1, 64, 4, 1, 32, 64, 32, True, None),
    (2, 256, 4, 2, 32, 64, 64, True, 32),
    (2, 256, 4, 2, 32, 64, 64, True, 96),
    (2, 256, 4, 2, 32, 64, 64, True, 1024),
    (1, 128, 4, 4, 32, 64, 64, False, None),
    (1, 100, 4, 2, 32, 64, 48, True, None),
    (1, 100, 4, 2, 32, 32, 64, True, 40),
]
# qwen3-0.6b's prefill buckets (B=1, H=16, KH=8, D=128), and 16
QWEN_SEQS = (16, 64, 128, 256, 512, 1024)
# recurrentgemma-9b's local attention (H=16, KH=1, D=256, window 2048) at
# two buckets, and at S=4096, where the window masks
HYBRID_SEQS = (128, 1024, 4096)
HYBRID_WINDOW = 2048
SSD_CASES = [                     # tests/test_kernels.py:69-73, + full width
    # (b, s, h, p, g, n, chunk)
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 32, 2, 16, 32),
    (1, 256, 8, 16, 1, 32, 64),
    (1, 256, 80, 64, 1, 128, 256),
    (1, 1024, 80, 64, 1, 128, 256),
]
RGLRU_CASES = [                   # tests/test_kernels.py:96-100, + full width
    # (b, s, w)
    (1, 64, 32), (2, 128, 64), (1, 256, 128), (1, 64, 4096), (1, 1024, 4096),
]


def say(phase: str, **kw):
    print(f"[{phase}] " + json.dumps(kw), flush=True)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return out[0]


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    """The least time on the card, ms, and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def gen(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def on_card(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEV, dtype)


# ---------------------------------------------------------------------------
# Phase 2: build
# ---------------------------------------------------------------------------


def _short(function: str) -> str:
    """``void <unnamed>::flash_fwd<float, (int)256, (int)16>(float const*,
    ...)`` -> ``flash_fwd<float, 256, 16>``."""
    name = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::|\(int\)",
                  "", function)
    return re.sub(r"\([^()]*\)$", "", name)


def build_kernels():
    from repro_torch.kernels import _build
    seconds = _build.build_all()
    for name in _build.SOURCES:
        rows = [dict(r, function=_short(r["function"]))
                for r in _build.ptxas_summary(name)]
        say("build", source=f"src/repro_torch/csrc/{name}.cu",
            seconds=seconds[name], kernels=rows)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def _verdict(kernel, got, want, atol, rtol, **case) -> float:
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, atol=atol, rtol=rtol)
              and torch.isfinite(got).all())
    say("check", kernel=kernel, **case, max_abs_err=err,
        mean_abs_out=float(want.abs().mean()), atol=atol, rtol=rtol, ok=ok)
    if not ok:
        raise AssertionError(f"{kernel} disagrees with its plain version at "
                             f"{case}: max abs err {err}")
    return err


def _qkv(rng, b, s, h, kh, d, dtype):
    return [on_card(rng.normal(size=shape) * 0.3, dtype)
            for shape in [(b, s, h, d), (b, s, kh, d), (b, s, kh, d)]]


def check_flash():
    """Returns the largest bf16 abs error at each path's shapes: (qwen3,
    D=128; recurrentgemma, D=256)."""
    from repro_torch.kernels import flash_attention as fa
    rng = gen(0)
    cases = [(c, None) for c in FLASH_CASES]
    cases += [((1, s, 16, 8, 128, min(128, s), min(128, s), True, None),
               "d128") for s in QWEN_SEQS]
    cases += [((1, s, 16, 1, 256, 128, 128, True, HYBRID_WINDOW), "d256")
              for s in HYBRID_SEQS]
    worst = {"d128": 0.0, "d256": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for (b, s, h, kh, d, qb, kb, causal, window), path in cases:
            q, k, v = _qkv(rng, b, s, h, kh, d, dtype)
            got = fa.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, q_block=qb,
                                            kv_block=kb)
            err = _verdict("flash_attention", got, want, *TOL[dtype],
                           dtype=str(dtype), shape=[b, s, h, kh, d],
                           causal=causal, window=window)
            if path and dtype == torch.bfloat16:
                worst[path] = max(worst[path], err)
    return worst


def _ssd_inputs(rng, b, s, h, p, g, n, dtype):
    x = on_card(rng.normal(size=(b, s, h, p)), dtype)
    dt = on_card(np.abs(rng.normal(size=(b, s, h))) * 0.1 + 0.01)
    A = on_card(-np.abs(rng.normal(size=h)) - 0.1)
    Bm = on_card(rng.normal(size=(b, s, g, n)), dtype)
    Cm = on_card(rng.normal(size=(b, s, g, n)), dtype)
    return x, dt, A, Bm, Cm


def check_ssd() -> float:
    """Returns the largest abs error of bf16 y at the full-width shapes."""
    from repro_torch.kernels import ssd_scan as ssd
    rng = gen(1)
    worst = 0.0
    for dtype, tol in ((torch.float32, "ssd_f32"),
                       (torch.bfloat16, "ssd_bf16")):
        for b, s, h, p, g, n, chunk in SSD_CASES:
            args = _ssd_inputs(rng, b, s, h, p, g, n, dtype)
            y, fin = ssd.ssd_scan_cuda(*args, chunk=chunk)
            torch.cuda.synchronize()
            yw, finw = ssd.ssd_scan_plain(*args, chunk=chunk)
            case = dict(dtype=str(dtype), shape=[b, s, h, p, g, n],
                        chunk=chunk)
            frac, rtol = SCALED_TOL[tol]
            err = _verdict("ssd_scan", y, yw,
                           frac * float(yw.float().abs().mean()), rtol,
                           output="y", frac_of_mean=frac, **case)
            frac, rtol = SCALED_TOL["ssd_f32"]
            _verdict("ssd_scan", fin, finw, frac * float(finw.abs().mean()),
                     rtol, output="final_state", frac_of_mean=frac, **case)
            if dtype == torch.bfloat16 and h == 80:
                worst = max(worst, err)
    return worst


def _rglru_inputs(rng, b, s, w):
    if w == 4096:     # the model's gates: a = exp(-8 softplus(lam) r) in
        a = rng.uniform(0.9, 1.0, size=(b, s, w))      # [0.9, 1)
    else:             # tests/test_kernels.py's
        a = 1 / (1 + np.exp(-rng.normal(size=(b, s, w)))) * 0.98 + 0.01
    return on_card(a), on_card(rng.normal(size=(b, s, w)))


def check_rglru() -> float:
    """Returns the largest abs error at the full-width shapes."""
    from repro_torch.kernels import rglru_scan as rg
    rng = gen(2)
    worst = 0.0
    frac, rtol = SCALED_TOL["rglru"]
    for b, s, w in RGLRU_CASES:
        a, bb = _rglru_inputs(rng, b, s, w)
        h = rg.rglru_scan_cuda(a, bb)
        torch.cuda.synchronize()
        want = rg.rglru_scan_plain(a, bb)
        err = _verdict("rglru_scan", h, want,
                       frac * float(want.abs().mean()), rtol,
                       dtype="torch.float32", shape=[b, s, w],
                       frac_of_mean=frac)
        if w == 4096:
            worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# Phase 4: time each kernel
# ---------------------------------------------------------------------------


def attention_bound(b, s, h, kh, d, window=None):
    """Least time for causal bf16 attention on the card, from this call's
    inputs: q, k, v read once and the output written once (2 bytes each);
    4*D flops (two products) for every unmasked (query, key) pair, at the
    bf16 tensor-core rate."""
    w = s if window is None else min(window, s)
    pairs = sum(min(i + 1, w) for i in range(s))
    return bound(4 * d * b * h * pairs,
                 2 * (2 * b * s * h * d + 2 * b * s * kh * d))


def ssd_bound(b, s, h, p, g, n, q, x_bytes=2):
    """Least time for the SSD scan: x, B, C (x_bytes each), dt (f32) and A
    read once, y and the f32 final state written once; per chunk C.B^T over
    i >= j once per group, and per head the weighted product with x over
    i >= j, the incoming state's product and the state update (2 flops per
    multiply-add), at the bf16 tensor-core rate."""
    tri = q * (q + 1) // 2
    per_chunk = g * tri * n * 2 + h * (tri * p * 2 + 2 * q * n * p * 2)
    nbytes = (2 * b * s * h * p * x_bytes + 2 * b * s * g * n * x_bytes
              + b * s * h * 4 + h * 4 + b * h * p * n * 4)
    return bound(b * (s // q) * per_chunk, nbytes)


def rglru_bound(b, s, w):
    """a and b read, h written, f32; one multiply-add per element."""
    return bound(2 * b * s * w, 3 * b * s * w * 4)


def time_flash():
    """K3 at qwen3's S=1024 and 4096 (D=128) and recurrentgemma's S=1024
    (D=256, window 2048)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rng = gen(3)
    rows = {}
    for path, (b, s, h, kh, d, window) in (
            ("d128", (1, 1024, 16, 8, 128, None)),
            ("d128_4096", (1, 4096, 16, 8, 128, None)),
            ("d256", (1, 1024, 16, 1, 256, HYBRID_WINDOW))):
        q, k, v = _qkv(rng, b, s, h, kh, d, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        blk = min(128, s)
        bound_ms, bound_by = attention_bound(b, s, h, kh, d, window)
        # window >= S here, so causal SDPA computes the same function
        assert window is None or window >= s
        row = dict(
            ms=event_ms(lambda: fa.flash_attention_cuda(
                q, k, v, causal=True, window=window), 50),
            library_ms=event_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 50),
            plain_ms=event_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=True, window=window, q_block=blk,
                kv_block=blk), 3, 1),
            bound_ms=bound_ms, bound_by=bound_by)
        say("time", kernel="flash_attention", dtype="bf16",
            shape=[b, s, h, kh, d], window=window, library="SDPA", **row)
        rows[path] = row
    return rows


def time_ssd():
    """K5 at mamba2-2.7b's full width, S=1024, bf16 x/B/C as in serving."""
    from repro_torch.kernels import ssd_scan as ssd
    shape = (1, 1024, 80, 64, 1, 128)
    args = _ssd_inputs(gen(4), *shape, torch.bfloat16)
    bound_ms, bound_by = ssd_bound(*shape, 256)
    row = dict(ms=event_ms(lambda: ssd.ssd_scan_cuda(*args, chunk=256), 20),
               plain_ms=event_ms(lambda: ssd.ssd_scan_plain(
                   *args, chunk=256), 3, 1),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    say("time", kernel="ssd_scan", dtype="bf16", shape=list(shape), chunk=256,
        library="none: no single PyTorch call computes the SSD scan", **row)
    return row


def time_rglru():
    """K6 at recurrentgemma-9b's full width, S=1024."""
    from repro_torch.kernels import rglru_scan as rg
    a, bb = _rglru_inputs(gen(5), 1, 1024, 4096)
    bound_ms, bound_by = rglru_bound(1, 1024, 4096)
    row = dict(ms=event_ms(lambda: rg.rglru_scan_cuda(a, bb), 50),
               plain_ms=event_ms(lambda: rg.rglru_scan_plain(a, bb), 3, 1),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    say("time", kernel="rglru_scan", dtype="f32", shape=[1, 1024, 4096],
        library="none: no single PyTorch call computes a linear recurrence",
        **row)
    return row


# ---------------------------------------------------------------------------
# Phases 5 and 6: serve each model; logits
# ---------------------------------------------------------------------------


def wrappers():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ssd
    return {"flash_attention": fa.flash_attention_cuda,
            "ssd_scan": ssd.ssd_scan_cuda, "rglru_scan": rg.rglru_scan_cuda}


def per_prefill(cfg) -> dict:
    """Each kernel's launches in one prefill of ``cfg``'s path."""
    from repro_torch.models import rglru
    n = {name: 0 for name in wrappers()}
    if cfg.family == "dense":
        n["flash_attention"] = cfg.num_layers
    elif cfg.family == "ssm":
        n["ssd_scan"] = cfg.num_layers
    elif cfg.family == "hybrid":       # 2 recurrent blocks a super, + tail
        n["flash_attention"] = rglru.n_super(cfg)
        n["rglru_scan"] = 2 * rglru.n_super(cfg) + rglru.n_tail(cfg)
    return n


def serve(cfg, params, n_req: int = 16) -> dict:
    """Phase 5. Returns each kernel's launch count over the measured run."""
    from repro_torch.launch.serve import (WORKLOAD_NEW_TOKENS, run_timed,
                                          workload)

    new_tokens = WORKLOAD_NEW_TOKENS
    run_timed(*workload(cfg, params, 2, seed=1))         # warm-up
    eng, reqs = workload(cfg, params, n_req)
    kernels = wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    wall = run_timed(eng, reqs)
    launches = {name: fn.launches for name, fn in kernels.items()}

    if not all(r.done and len(r.out_tokens) == new_tokens for r in reqs):
        raise AssertionError("a request did not finish with "
                             f"{new_tokens} tokens")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens):
        raise AssertionError("a generated token id is out of the vocab")
    # each request is prefilled once, on admission
    want = {k: v * n_req for k, v in per_prefill(cfg).items()}
    if launches != want:
        raise AssertionError(f"{cfg.name}: kernel launches {launches}; want "
                             f"{per_prefill(cfg)} per prefill x {n_req}")
    lat = [r.done_s - r.submitted_s for r in reqs]
    ttft = [r.first_token_s - r.submitted_s for r in reqs]
    tokens = sum(len(r.out_tokens) for r in reqs)
    say("serve", arch=cfg.name, requests=n_req, new_tokens=new_tokens,
        prompt_lens=[len(r.prompt) for r in reqs], wall_s=wall,
        tokens_per_s=tokens / wall,
        p50_latency_s=float(np.percentile(lat, 50)),
        p90_latency_s=float(np.percentile(lat, 90)),
        p50_ttft_s=float(np.percentile(ttft, 50)),
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, launches_per_prefill=per_prefill(cfg),
        engine=eng.stats())
    return launches


def logits_parity(cfg, params):
    """Phase 6. Last-token prefill logits of two 1024-token prompts through
    the kernels, through the plain route (``use_pallas=False``), and
    through the plain route in f32 weights. The dense family's prompts are
    right-padded (300 and 1000 tokens: the engine's ragged prefill); the
    recurrent families read no ``prompt_lens``, so theirs are whole.

    Tolerance: both bf16 routes run every layer in bf16 and round at
    different places, so neither equals the f32 run; the kernel route must
    stay as close to it as the plain route does, within 1.5x plus 2**-8 of
    the largest f32 logit (one bf16 rounding at that scale)."""
    from repro_torch.models import model_api as api

    rng = gen(6)
    lens = np.array([300, 1000] if cfg.family == "dense" else [1024, 1024])
    tokens = np.zeros((2, 1024), np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(1, cfg.vocab_size, n)
    batch = {"tokens": torch.from_numpy(tokens).to(DEV)}
    if cfg.family == "dense":
        batch["prompt_lens"] = torch.from_numpy(lens).to(DEV)
    plain_cfg = cfg.replace(use_pallas=False)
    with torch.inference_mode():
        lk = api.prefill(cfg, params, batch, 1024)[0].float()
        lp = api.prefill(plain_cfg, params, batch, 1024)[0].float()
        p32 = _tree_float(params)
        lf = api.prefill(plain_cfg, p32, batch, 1024)[0].float()
        del p32
    if lk.shape != (2, 1, cfg.vocab_size) or not torch.isfinite(lk).all():
        raise AssertionError(f"kernel-route logits: shape {tuple(lk.shape)}"
                             f", finite {bool(torch.isfinite(lk).all())}")
    scale = float(lf.abs().max())
    err_k = float((lk - lf).abs().max())
    err_p = float((lp - lf).abs().max())
    limit = 1.5 * err_p + 2 ** -8 * scale
    say("logits", arch=cfg.name, prompt_lens=lens.tolist(),
        f32_layers=cfg.num_layers, max_abs_f32_logit=scale,
        kernel_vs_f32=err_k, plain_vs_f32=err_p,
        kernel_vs_plain=float((lk - lp).abs().max()), limit=limit,
        same_argmax=bool((lk.argmax(-1) == lp.argmax(-1)).all()))
    if not err_k <= limit:
        raise AssertionError(f"{cfg.name}: kernel-route logits are {err_k} "
                             f"from the f32 run; the plain route's are "
                             f"{err_p}")


def _tree_float(tree):
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    return tree.float()


def run_model(arch: str) -> dict:
    """Phases 5 and 6 for one model; frees its weights. Returns the kernel
    launches of its serving run."""
    from repro_torch import device as devmod
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_api as api

    dev = devmod.resolve(DEV)
    cfg = get_config(arch).replace(use_pallas=True)
    params = api.init_params(cfg, devmod.generator(0, dev), dev)
    launches = serve(cfg, params)
    logits_parity(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power()
    print(card, flush=True)
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)

    build_kernels()
    err_fa = check_flash()
    err_ssd = check_ssd()
    err_rg = check_rglru()
    t_fa, t_ssd, t_rg = time_flash(), time_ssd(), time_rglru()
    launches = {arch: run_model(arch) for arch in MODELS}

    def entry(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    print(json.dumps({"kernels": [
        entry("flash_attention", "flash_attention",
              "src/repro/kernels/flash_attention.py:80",
              launches["qwen3-0.6b"]["flash_attention"], err_fa["d128"],
              t_fa["d128"]),
        entry("flash_attention_d256", "flash_attention",
              "src/repro/kernels/flash_attention.py:80",
              launches["recurrentgemma-9b"]["flash_attention"],
              err_fa["d256"], t_fa["d256"]),
        entry("ssd_scan", "ssd_scan", "src/repro/kernels/ssd_scan.py:75",
              launches["mamba2-2.7b"]["ssd_scan"], err_ssd, t_ssd),
        entry("rglru_scan", "rglru_scan",
              "src/repro/kernels/rglru_scan.py:48",
              launches["recurrentgemma-9b"]["rglru_scan"], err_rg, t_rg),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
