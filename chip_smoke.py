#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Serving qwen3-0.6b at full width through ``repro_torch.serving.engine``,
with prefill attention through the hand-written flash attention kernel
(``src/repro_torch/csrc/flash_attention.cu``). Phases, each printing its
numbers on lines of its own:

  1. the card's name and power limit, as nvidia-smi gives them;
  2. build the kernel from the checkout's source and print the build
     seconds;
  3. hold the kernel against its plain PyTorch version in bf16 and f32, on
     the cases of tests/test_kernels.py and at the main path's shapes, to
     the tolerance of ``TOL``;
  4. time the kernel at S=1024 and S=4096 beside its plain version, the
     library call that computes the same function (SDPA, a yardstick the
     port never calls) and its bound on the card;
  5. serve 16 requests (prompts of 64-1000 tokens, 32 new tokens each) at
     full width, bf16, random weights from seed 0, batch 4, context 1024,
     with every kernel's launch count set to 0 just before and read just
     after;
  6. hold the prefill's last-token logits through the kernel against the
     plain route and an f32 run of the same weights;
  7. print one line listing every kernel, then the result line.

Any failed phase raises, so the script exits non-zero and prints no result
line. Without a visible card it exits non-zero at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen3-0.6b"
PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
# (atol, rtol) of the kernel against its plain version. Both compute in f32
# and round the output once to the input dtype, so they differ by the order
# of f32 sums and, in bf16, by at most one rounding of the output: one bf16
# step, 2**-7 of the value or less. f32 keeps tests/test_kernels.py's 2e-5.
# bf16 takes rtol 2**-7 and atol 2e-4, well under a typical |out| (about
# 1e-2 at S=1024 with these inputs); test_kernels.py's bf16 2e-2 would pass
# a kernel that is wrong by a whole typical value.
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-4, 2 ** -7)}
KERNEL_CASES = [                  # tests/test_kernels.py:20-49, + ragged
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
# prefill buckets of the serving run (B=1, H=16, KH=8, D=128), and 16
MAIN_PATH_SEQS = (16, 64, 128, 256, 512, 1024)


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


def qkv(gen, b, s, h, kh, d, dtype):
    def draw(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.3
                ).to(dtype)
    return draw(b, s, h, d), draw(b, s, kh, d), draw(b, s, kh, d)


def attention_bound(b, s, h, kh, d):
    """Least time for causal bf16 attention on the card, from this call's
    inputs: q, k, v read once and the output written once (2 bytes each);
    4*D flops (two products) for every unmasked (query, key) pair, at the
    bf16 tensor-core rate."""
    flops = 4 * d * b * h * (s * (s + 1) // 2)
    nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kh * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_kernel(fa) -> float:
    """Phase 3. Returns the largest abs error at the main path's shapes in
    bf16, the dtype the path runs."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(c, False) for c in KERNEL_CASES] + [
        ((1, s, 16, 8, 128, min(128, s), min(128, s), True, None), True)
        for s in MAIN_PATH_SEQS]
    worst_main = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for (b, s, h, kh, d, qb, kb, causal, window), main in cases:
            q, k, v = qkv(gen, b, s, h, kh, d, dtype)
            got = fa.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, q_block=qb,
                                            kv_block=kb)
            err = float((got.float() - want.float()).abs().max())
            atol, rtol = TOL[dtype]
            ok = bool(torch.allclose(got.float(), want.float(), atol=atol,
                                     rtol=rtol))
            say("check", kernel="flash_attention", dtype=str(dtype),
                shape=[b, s, h, kh, d], causal=causal, window=window,
                max_abs_err=err, mean_abs_out=float(want.float().abs().mean()),
                atol=atol, rtol=rtol, ok=ok)
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(f"flash_attention disagrees with its "
                                     f"plain version at {(b, s, h, kh, d)} "
                                     f"{dtype}: max abs err {err}")
            if main and dtype == torch.bfloat16:
                worst_main = max(worst_main, err)
    return worst_main


def time_kernel(fa):
    """Phase 4, at B=1, H=16, KH=8, D=128, bf16, causal."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for s in (1024, 4096):
        q, k, v = qkv(gen, 1, s, 16, 8, 128, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        blk = min(128, s)
        bound, bound_by = attention_bound(1, s, 16, 8, 128)
        row = dict(
            seq=s,
            ms=event_ms(lambda: fa.flash_attention_cuda(q, k, v,
                                                        causal=True), 50),
            library_ms=event_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 50),
            plain_ms=event_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=True, q_block=blk, kv_block=blk), 3, 1),
            bound_ms=bound, bound_by=bound_by)
        say("time", kernel="flash_attention", dtype="bf16",
            shape=[1, s, 16, 8, 128], **row)
        rows[s] = row
    return rows


def serve(cfg, params, fa):
    """Phase 5. Returns the kernel's launch count over the measured run."""
    from repro_torch.launch.serve import (WORKLOAD_NEW_TOKENS, run_timed,
                                          workload)

    n_req, new_tokens = 16, WORKLOAD_NEW_TOKENS
    run_timed(*workload(cfg, params, 2, seed=1))         # warm-up
    eng, reqs = workload(cfg, params, n_req)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_cuda.launches = 0
    wall = run_timed(eng, reqs)
    launches = fa.flash_attention_cuda.launches

    if not all(r.done and len(r.out_tokens) == new_tokens for r in reqs):
        raise AssertionError("a request did not finish with "
                             f"{new_tokens} tokens")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens):
        raise AssertionError("a generated token id is out of the vocab")
    # each request is prefilled once, on admission; one launch per layer
    if launches != cfg.num_layers * n_req:
        raise AssertionError(f"flash_attention launched {launches} times; "
                             f"want {cfg.num_layers} x {n_req} prefills")
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
        flash_attention_launches=launches,
        launches_per_request=launches / n_req, engine=eng.stats())
    return launches


def logits_parity(cfg, params):
    """Phase 6. Last-token prefill logits of two right-padded prompts (the
    engine's ragged prefill) through the kernel, through the plain route
    (``use_pallas=False``), and through the plain route in f32 weights.

    Tolerance: both bf16 routes run 28 bf16 layers and round at different
    places, so neither equals the f32 run; the kernel route must stay as
    close to it as the plain route does, within 1.5x plus 2**-8 of the
    largest f32 logit (one bf16 rounding at that scale)."""
    from repro_torch.models import model_api as api

    rng = np.random.default_rng(2)
    lens = np.array([300, 1000])
    tokens = np.zeros((2, 1024), np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(1, cfg.vocab_size, n)
    batch = {"tokens": torch.from_numpy(tokens).cuda(),
             "prompt_lens": torch.from_numpy(lens).cuda()}
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
    say("logits", prompt_lens=lens.tolist(), max_abs_f32_logit=scale,
        kernel_vs_f32=err_k, plain_vs_f32=err_p,
        kernel_vs_plain=float((lk - lp).abs().max()), limit=limit,
        same_argmax=bool((lk.argmax(-1) == lp.argmax(-1)).all()))
    if not err_k <= limit:
        raise AssertionError(f"kernel-route logits are {err_k} from the f32 "
                             f"run; the plain route's are {err_p}")


def _tree_float(tree):
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    return tree.float()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from repro_torch import device as devmod
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model_api as api

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power()
    print(card, flush=True)
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)

    build_s = _build.build("flash_attention")
    ptxas = [ln.strip() for ln in _build.build_report(
        "flash_attention").splitlines() if "registers" in ln
        or "spill" in ln]
    say("build", source="flash_attention", seconds=build_s, ptxas=ptxas)

    max_err = check_kernel(fa)
    times = time_kernel(fa)

    dev = devmod.resolve(None)
    cfg = get_config(ARCH).replace(use_pallas=True)
    params = api.init_params(cfg, devmod.generator(0, dev), dev)
    launches = serve(cfg, params, fa)
    logits_parity(cfg, params)

    t = times[1024]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:80",
        "launches": launches, "max_abs_err": max_err, "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
