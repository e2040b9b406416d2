#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA card: the FDN
admission path, the Inspector's scenarios, the serving paths, the split-K
decode attention entry point and the training path.

    python3 chip_smoke.py

The admission path runs ``examples/batch_scheduling.py``'s stream through
``repro_torch.launch.batch_scheduling``: 100,000 Poisson arrivals of
``nodeinfo`` over 600 simulated seconds (seed 42), in 50 ms windows through
``Gateway.request_batch`` to the paper's five platforms, each window decided
by the SLO-composite policy, whose decision runs on the card through the
policy-score kernel K1 (``src/repro_torch/csrc/policy_score.cu``, with K2 in
the same source).

The Inspector (``repro_torch.inspector``, with the function chains of
``repro_torch.chains``, the warm-pool controller of ``repro_torch.autoscale``
and the flight recorder, telemetry and decision journal of
``repro_torch.obs``) runs the seven registry scenarios that have a golden in
benchmarks/golden/, and prov/smoke-tiny, at their registered sizes through
``repro_torch.launch.inspector_scenario``: smoke/tiny, paper/fig10-weighted,
qos/burst-storm-drr, chains/etl-pipeline, autoscale/diurnal-predictive and
-ttl, telemetry/hpc-outage. Their decisions reach K1 on the control plane's
columnar admission path, behind the QoS admission controller, under the
telemetry engine and under the decision journal, which the admission stream
does not take. The autoscale arms' warm-pool forecaster ticks on the card
(``repro_torch.kernels.warm_forecast``: torch ops, as the JAX package's tick
is ``jax.jit`` and no Pallas kernel). The twins of examples/serve_fdn.py and
examples/energy_aware_scheduling.py (``repro_torch.launch.serve_fdn`` and
``.energy_aware_scheduling``) follow: serve_fdn reaches K1 on a path that
no earlier phase takes, with hedging and predictive prewarming on, one
invocation at a time through ``Gateway.request``.

Four models are served at full width through ``repro_torch.serving.engine``,
one after another (each one's weights are freed before the next loads):

* qwen3-0.6b (dense): prefill attention through the flash attention kernel
  (``src/repro_torch/csrc/flash_attention.cu``, K3) at head_dim 128;
* mamba2-2.7b (SSM): prefill through the SSD chunked scan kernel
  (``csrc/ssd_scan.cu``, K5);
* recurrentgemma-9b (hybrid): prefill through the RG-LRU scan kernel
  (``csrc/rglru_scan.cu``, K6) and local attention through K3 at head_dim
  256;
* mixtral-8x7b (MoE, top-2 of 8 experts, window 4096) at 24 of its 32
  layers, every width as published (its 32 layers, 93.4 GB of bf16 weights,
  do not fit the card's 80 GB): prefill attention through K3 at head_dim
  128, 32 query heads over 8 kv heads.

Two more run through ``repro_torch.models.model_api`` (prefill, then greedy
decode steps), at full width and depth, because the engine feeds token ids
only, as the JAX engine does: phi-3-vision-4.2b (VLM: 576 stub image
embeddings in front of the text), whose prefill attention runs K3 at
head_dim 96, and whisper-small (encoder-decoder over 1,500 stub audio
frames), which runs no kernel, in the JAX package as here.

Split-K decode attention (``kernels/ops.decode_attention``, the kernel
``csrc/decode_attention.cu``, K4) is an entry point that no serving path
calls, in the JAX package as in the port: decode runs ``layers.attend``. Its
own path is held on the caches that qwen3-0.6b's and recurrentgemma-9b's
prefill build, and it must launch 0 times while they serve.

The training path (``repro_torch.launch.train.train_loop``, the loop of the
trainer entry point) trains qwen3-0.6b at full width and depth on the plain
routes with autograd's backward, as the JAX package trains through plain
``jnp``: no kernel runs there, and a kernel entry point raises under
autograd.

Phases, each printing its numbers on lines of its own:

  1. the card's name and power limit, as nvidia-smi gives them;
  2. build the five kernel sources from the checkout, one nvcc each, all
     started together; print the seconds and ptxas's registers and spills
     per kernel instance; every bf16 instance of K3 and both bf16 kernels
     of K5 must hold HGMMA (wgmma) in their SASS, every bf16 instance of K4
     for groups of more than 8 HMMA (mma.sync), and no bf16 instance of K3,
     K4 or K5 may spill;
  3. hold every kernel against its plain PyTorch version on the cases of
     tests/test_kernels.py and at the serving paths' shapes, each tolerance
     printed beside the output's mean |value|; K6 also at the serving
     buckets S = 16, 64, 256 and 512 and at S = 1, 5 and 100; K3 on the cases of
     ``tests/flash_attention_cases.py`` and at every prefill bucket of both
     paths (and at mixtral's and phi-3-vision's prefill shapes); K5 on the
     cases of ``tests/ssd_scan_cases.py`` (f32 and bf16)
     and its large-decay case at full width; K1 and K2 bit-equal on the
     cases of ``tests/policy_score_cases.py`` at the admission path's
     shapes and a registry-scale one; K4, through its entry point
     ``ops.decode_attention``, on the cases of
     ``tests/decode_attention_cases.py``: tests/test_kernels.py's, lengths
     0, 1, T, split_len and split_len + 1, T=1152 and T=100, groups of 16
     to 64, and both serving caches (B=4, T=1152; qwen3-0.6b's KH=8, D=128
     and recurrentgemma-9b's local KH=1, D=256), where one call must run
     one kernel on the card (the kernel nodes of a CUDA-graph capture);
     the warm-pool forecaster's tick on the card against the NumPy tick:
     gap buckets at every power of two and one below it, decisions
     byte-equal on the reference test's seeded stream and at 4,096 rows;
  4. time every kernel at its path's full-width shape with S=1024 (K3 also
     at phi-3-vision's B=4, head_dim 96; K1 and
     K2 at the admission path's F x P and at F=4096, P=1024) beside its
     plain version, its bound on the card and, where one PyTorch call
     computes the same function, that call (SDPA for K3: a yardstick the
     port never calls), K3 and SDPA also by device time inside a CUDA
     graph; K5 and K6 also at the serving buckets S=256, 512 and 768, by
     device time in a CUDA graph, with their kernels a call; K4 at both
     serving caches with lengths = T beside
     its plain version, ``layers.attend`` (what decode runs) and SDPA with a
     boolean length mask; time the admission decision as the path makes
     it (K1 on its pinned staging block), under each backend, at F = 1,
     5, 10, 64, 128 and 256 functions over the five platforms, and K1's
     staged route alone; time the forecaster's tick at 25, 256, 4,096 and
     65,536 managed rows, NumPy against torch on the card (median of three
     turns);
  5. admission: every policy picks the same platforms under the numpy
     backend, the torch backend and torch with the kernel, on
     tests/test_admission_fastpath.py's randomized platform states; then
     the 100,000-arrival stream three ways (numpy, torch, torch with K1)
     with identical outcomes, every kernel's launch count set to 0 just
     before the K1 run and read just after, and K1's launches equal to the
     torch decisions; then the Inspector's eight scenarios three ways
     (numpy, torch, torch with K1; the autoscale arms two ways, numpy and
     torch with K1 and the forecaster on the card) with byte-identical
     reports, every kernel's launch count set to 0 just before each run
     and read just after (K1's equal to the K1 run's torch decisions,
     above 0 in every scenario but paper/fig10-weighted and the autoscale
     arms, where a load balancer or a platform override leaves the policy
     nothing to decide: 0 there; every other kernel 0), the forecaster's
     torch ticks above 0 in autoscale/diurnal-predictive, the journal's
     same-policy replay true in prov/smoke-tiny, and each report with a
     golden in benchmarks/golden/ without drift against it
     (``benchmarks/scenario_diff.diff_reports``); then the twins of the
     last two examples (``[examples]``), with every real body's measured
     seconds pinned to ``tests/example_pins.py``'s: serve_fdn (the five
     simulated TPU platforms, hedging and predictive prewarming on, the
     five paper functions and three analytic serving functions, each
     invocation admitted alone through ``Gateway.request``) three ways,
     numpy, torch and torch with K1, and energy_aware_scheduling (Table 4
     and the energy-aware policy's two choices) two ways, numpy and torch,
     each twin's report byte-identical across its runs, every kernel's
     launch count set to 0 just before each run and read just after (K1's
     equal to serve_fdn's torch decisions in its K1 run, every other count
     0); then serve_fdn under torch with K1 and energy_aware_scheduling
     under torch once more with the real bodies on the card, each body's
     measured seconds printed;
  6. per served model: serve 16 requests (prompts of 64-1000 tokens, 32 new
     tokens each) at full width, bf16, random weights from seed 0, batch 4,
     context 1024, with every kernel's launch count set to 0 just before
     and read just after, and each kernel's launches per prefill asserted;
     peak device memory printed;
  7. per model: hold the prefill's last-token logits through the kernels
     against the plain route and an f32 run of the same weights (mixtral's
     on its first 4 layers: an f32 copy of 24 does not fit);
  8. qwen3-0.6b and recurrentgemma-9b: K4, through its entry point, on
     every attention layer's cache as the model's own prefill builds it (ragged prompts of 64-1000
     tokens for qwen3, 1000 tokens for the hybrid's unwrapped ring),
     against its plain version and against ``layers.attend``, with K4's
     launch count set to 0 just before and read just after;
  9. phi-3-vision-4.2b and whisper-small through ``model_api``: batch 4 of
     ``make_batch``, one prefill and 32 greedy decode steps, timed, every
     kernel's launch count set to 0 just before and read just after (K3 32
     times for phi-3-vision, every kernel 0 for whisper-small), logits
     finite, tokens in the vocab, peak memory printed; then phase 7 on the
     same batch;
 10. train (``[train]``): qwen3-0.6b, 28 layers at full width, random bf16
     weights from seed 0, ``TokenStream`` batches of 8 x 4096 tokens (the
     batch cut from TRAIN_4K's 256 for one card) as 4 microbatches of 2,
     remat "dots", AdamW (lr 1e-3, 5 warmup steps of 6), under
     deterministic algorithms: steps 1-3 with an async checkpoint at step
     3, restored into fresh tensors on the card and held bit-equal to the
     trained state; steps 4-6; every kernel's launch count set to 0 just
     before step 1 and read after step 6 (all 0); each step's loss, lr,
     grad norm and ms, tokens/s and peak memory printed; the losses finite
     and falling; one step under remat "full" for its peak beside
     "dots"'s; a step with ``use_pallas`` raises before launching; steps
     4-6 again from the checkpoint, their losses equal to the
     uninterrupted run's; then reduced qwen3 in f32, one step on the card
     against the same step on the CPU (``[train_cpu]``);
 11. mesh (``[mesh]``): a (1, 1) ("data", "model") mesh over a world of
     one on the card (NCCL, an in-memory store; the script runs on one
     card, so every placement is ``Replicate``): qwen3-0.6b at full width
     and depth, its parameters placed by ``param_shardings`` and AdamW's
     state by ``state_shardings`` (ZeRO-1), one train step of 2 x 4096
     ``TokenStream`` tokens under deterministic algorithms, twice each way:
     each way's two steps bit-equal, the mesh's leaves held to the
     meshless ones by ``launch/mesh_parity.leaf_diffs``'s bounds (the
     card's step takes one of two bit patterns; parameters one
     bf16 ulp + 2.1 lr and 98% within one ulp + 0.05 lr; m and v element
     by element against |want| + the leaf's rms, every element within
     2**4 and 99% within 2**-7), loss 2**-6, grad norm 2**-5; the
     outputs in their declared placements; ms a step both ways); the
     sharded state saved and restored with ``shardings=`` onto the mesh,
     bit-equal; a prefill of 4 x 1024 tokens with ``use_pallas`` on the
     mesh, K3 through the local-shard wrapper (28 launches), then 32
     decode steps with ``decode_impl="shmap_flash"`` against the meshless
     prefill and greedy decode, fed its tokens (the same greedy choices
     wherever the top two logits are further apart than twice the largest
     logit difference, and the share that agree printed; the prefill's
     logits within TOL, the decode's within ``MESH_DECODE_TOL``; ms a step
     both ways); mixtral-8x7b on its first 4 layers, ``sorted_shmap`` on the
     mesh against ``sorted`` without one, outputs and aux bit-equal;
 12. dry-run (``[dryrun]``): ``python -m repro_torch.launch.dryrun --arch
     qwen3-0.6b --arch mixtral-8x7b --mesh both`` (full depth, 14 cells on
     fake worlds of 256 and 512 ranks) in a subprocess started after phase
     10, beside phase 11 only, on a host core of its own (with its
     hyperthread siblings; this process keeps the others); every cell OK;
     each cell's per-device argument bytes, FLOPs, collective bytes and
     seconds printed;
 13. print one line listing every kernel, then the result line.

Any failed phase raises, so the script exits non-zero and prints no result
line. Without a visible card it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the seeded kernel cases that the tests share (tests/policy_score_cases.py,
# tests/flash_attention_cases.py, tests/decode_attention_cases.py,
# tests/ssd_scan_cases.py)
sys.path.insert(1, str(ROOT / "tests"))

DEV = "cuda"
# served through the engine, with the depth cut each takes: mixtral-8x7b's
# 32 layers are 93.4 GB of bf16 weights, more than the card's 80 GB; 24 of
# them, every width as published, are 70.2 GB
MODELS = {"qwen3-0.6b": {}, "mamba2-2.7b": {}, "recurrentgemma-9b": {},
          "mixtral-8x7b": {"num_layers": 24}}
# mixtral's logits check (phase 7) runs its three routes on its first layers
# (the same weights): an f32 copy of 24 layers (135 GB) cannot fit
MOE_PARITY_LAYERS = 4
# driven through model_api.prefill and decode_step (the engine feeds token
# ids only, as the JAX engine does), full depth, batch 4: (make_batch's
# sequence length, decode steps). phi-3-vision: 576 image + 448 text
# positions; whisper-small: 64 prompt tokens beside its 1,500 frames.
API_MODELS = {"phi-3-vision-4.2b": (1024, 32), "whisper-small": (64, 32)}
API_BATCH = 4
PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12            # H100 SXM f32 outside the tensor cores
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
# kernel chains the steps of a block's walk and the 8 warp segments of each
# step; emulated in f32 (tests/test_torch_rglru_scan.py) that lies 5.7e-6
# from the sequential scan at S=1024, W=4096, where m is 2.5 (2.3e-6 of m),
# and within 0-0.07 of this limit at S=1-5000: 2e-5 * m and rtol 1e-5.
SCALED_TOL = {"ssd_f32": (1e-4, 1e-5), "ssd_bf16": (1e-3, 2 ** -7),
              "rglru": (2e-5, 1e-5)}
# qwen3-0.6b's prefill buckets (B=1, H=16, KH=8, D=128), and 16
QWEN_SEQS = (16, 64, 128, 256, 512, 1024)
# recurrentgemma-9b's local attention (H=16, KH=1, D=256, window 2048) at
# two buckets, and at S=4096, where the window masks
HYBRID_SEQS = (128, 1024, 4096)
HYBRID_WINDOW = 2048
# mixtral-8x7b's attention (H=32, KH=8, D=128, window 4096) at its prefill
# buckets, qwen3's; phi-3-vision's prefill (B=4, S=1024, H=KH=32, D=96)
MIXTRAL_WINDOW = 4096
PHI3_PREFILL = (4, 1024, 32, 32, 96)
RGLRU_CASES = [                   # tests/test_kernels.py:96-100, + full width
    # (b, s, w)
    (1, 64, 32), (2, 128, 64), (1, 256, 128), (1, 64, 4096), (1, 1024, 4096),
    # the serving buckets (serving/engine.py) and short sequences
    (1, 16, 4096), (1, 256, 4096), (1, 512, 4096), (1, 1, 4096),
    (1, 5, 4096), (1, 100, 4096),
]
# K4 against layers.attend, per element: |K4 - attend| <= 2**-7 * (|attend|
# + sum_j p_j |v_j|). attend rounds its probabilities to bf16 before the
# product with v, which moves the output by at most 2**-9 * sum_j p_j |v_j|,
# and each side rounds its output once. On the CPU, at these serving shapes
# and normal inputs of scale 0.3-3, the error reached at most 0.50 of this
# limit (tests/test_torch_decode_attention.py).
ATTEND_LIMIT = 2 ** -7
# policy-score kernels: (F functions, P platforms). The admission stream
# decides F=1 (nodeinfo) over the paper's P=5 platforms; a mixed burst has
# F <= 10; 37 x 129 crosses the warp width in P; 4096 x 1024 is a
# registry-scale shape, for the record only.
POLICY_SHAPES = [(1, 5), (5, 5), (10, 5), (37, 129), (4096, 1024)]
POLICY_TIMED = [(1, 5), (5, 5), (4096, 1024)]
POLICY_WEIGHTS = (0.0, 0.1, 0.5)
# the admission decision's functions for the backend crossover (P = 5)
DECISION_FNS = (1, 5, 10, 64, 128, 256)
STREAM_ARRIVALS = 100_000


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


def graph_ms(fn, reps: int = 100) -> float:
    """Device time per call of ``fn``, with ``reps`` calls captured in one
    CUDA graph and the graph replayed: no host launch cost between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return event_ms(graph.replay, 10) / reps


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """The least time on the card, ms, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
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
    check_tensor_cores()


def _instances(source, want):
    """ptxas's rows for the kernels of ``csrc/<source>.cu`` whose name
    holds ``want``, with their HGMMA (wgmma) and HMMA (mma.sync) counts in
    the SASS and their spill bytes."""
    from repro_torch.kernels import _build
    sass = _build.sass(source)
    return [dict(function=_short(r["function"]),
                 hgmma=sass.get(r["function"], "").count("HGMMA"),
                 hmma=sass.get(r["function"], "").count("HMMA"),
                 registers=r.get("registers"),
                 spill_bytes=r["spill_stores"] + r["spill_loads"])
            for r in _build.ptxas_summary(source) if want in r["function"]]


def check_tensor_cores():
    """The bf16 instances run their products on the tensor cores and spill
    nothing: every bf16 K3 instance (one per head_dim) and both K5 kernels
    hold HGMMA (wgmma) in their SASS, every K4 instance for groups of more
    than 8 holds HMMA (mma.sync), and no bf16 instance of K3, K4 or K5
    spills. A kernel that lost its tensor-core route, or its registers,
    fails here."""
    from repro_torch.kernels import flash_attention as fa
    k3 = _instances("flash_attention", "__nv_bfloat16")
    k4 = _instances("decode_attention", "__nv_bfloat16")
    k4_mma = [f for f in k4 if "decode_mma_bf16" in f["function"]]
    k5 = [f for name in ("ssd_state_cb", "ssd_out")
          for f in _instances("ssd_scan", name)]
    # K4's tensor-core instances: blocks of 16, 32 and 64 rows at D=32 and
    # 64, of 16 and 32 at D=128, of 16 at D=256
    ok = (len(k3) == len(fa.HEAD_DIMS) and len(k5) == 2
          and len(k4_mma) == 9
          and all(f["hgmma"] > 0 for f in k3 + k5)
          and all(f["hmma"] > 0 for f in k4_mma)
          and all(f["spill_bytes"] == 0 for f in k3 + k4 + k5))
    say("tensor_cores", flash_attention_bf16=k3, decode_attention_bf16=k4,
        ssd_scan_bf16=k5, ok=ok)
    if not ok:
        raise AssertionError(f"bf16 instances must hold their tensor-core "
                             f"products and spill nothing: K3 {k3}, K4 {k4}, "
                             f"K5 {k5}")


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
    """Returns the largest bf16 abs error at each path's shapes: qwen3
    (D=128), recurrentgemma (D=256), mixtral (D=128, H=32) and phi-3-vision
    (D=96)."""
    from flash_attention_cases import CARD_CASES, card_inputs
    from repro_torch.kernels import flash_attention as fa
    rng = gen(0)
    cases = [(c, None) for c in CARD_CASES]
    cases += [((1, s, s, 16, 8, 128, True, None), "d128")
              for s in QWEN_SEQS]
    cases += [((1, s, s, 16, 1, 256, True, HYBRID_WINDOW), "d256")
              for s in HYBRID_SEQS]
    cases += [((1, s, s, 32, 8, 128, True, MIXTRAL_WINDOW), "mixtral")
              for s in QWEN_SEQS]
    b, s, h, kh, d = PHI3_PREFILL
    cases += [((b, s, s, h, kh, d, True, None), "d96")]
    worst = {"d128": 0.0, "d256": 0.0, "mixtral": 0.0, "d96": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for (b, s, t, h, kh, d, causal, window), path in cases:
            if path:
                q, k, v = _qkv(rng, b, s, h, kh, d, dtype)
            else:
                q, k, v = (on_card(x, dtype)
                           for x in card_inputs(b, s, t, h, kh, d))
            got = fa.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            err = _verdict("flash_attention", got, want, *TOL[dtype],
                           dtype=str(dtype), shape=[b, s, t, h, kh, d],
                           causal=causal, window=window)
            if path and dtype == torch.bfloat16:
                worst[path] = max(worst[path], err)
    return worst


def _ssd_inputs(case, dtype, large_decay=False):
    from ssd_scan_cases import inputs
    x, dt, A, Bm, Cm = inputs(*case, large_decay=large_decay)
    return (on_card(x, dtype), on_card(dt), on_card(A), on_card(Bm, dtype),
            on_card(Cm, dtype))


def check_ssd() -> float:
    """K5 on the cases of ``tests/ssd_scan_cases.py`` (f32 and bf16) and
    the large-decay case at full width (bf16). Returns the largest abs error
    of bf16 y at the full-width shapes."""
    from ssd_scan_cases import CASES, LARGE_DECAY
    from repro_torch.kernels import ssd_scan as ssd
    worst = 0.0
    runs = [(c, dtype, False) for dtype in (torch.float32, torch.bfloat16)
            for c in CASES] + [(LARGE_DECAY, torch.bfloat16, True)]
    for case, dtype, large in runs:
        b, s, h, p, g, n, chunk = case
        args = _ssd_inputs(case, dtype, large)
        y, fin = ssd.ssd_scan_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
        yw, finw = ssd.ssd_scan_plain(*args, chunk=chunk)
        info = dict(dtype=str(dtype), shape=[b, s, h, p, g, n], chunk=chunk,
                    large_decay=large)
        frac, rtol = SCALED_TOL["ssd_bf16" if dtype == torch.bfloat16
                                else "ssd_f32"]
        err = _verdict("ssd_scan", y, yw,
                       frac * float(yw.float().abs().mean()), rtol,
                       output="y", frac_of_mean=frac, **info)
        frac, rtol = SCALED_TOL["ssd_f32"]
        _verdict("ssd_scan", fin, finw, frac * float(finw.abs().mean()),
                 rtol, output="final_state", frac_of_mean=frac, **info)
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


def _decode_inputs(rng, b, t, h, kh, d, lengths, dtype):
    q = on_card(rng.normal(size=(b, h, d)) * 0.3, dtype)
    k, v = (on_card(rng.normal(size=(b, t, kh, d)) * 0.3, dtype)
            for _ in range(2))
    lens = rng.integers(1, t + 1, b) if lengths is None else lengths
    return q, k, v, on_card(np.asarray(lens), torch.int32)


def check_decode():
    """K4, through its entry point ``ops.decode_attention``, against its
    plain version on the shared cases (f32 and bf16) and at the serving
    caches with ragged lengths (bf16, as the caches are). Returns the
    largest bf16 abs error at the serving caches and, by serving cache, the
    kernels that one call launched (from a CUDA-graph capture)."""
    from decode_attention_cases import CASES, SERVING, serving_case
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    rng = gen(9)
    cases = [(c, None) for c in CASES.values()]
    cases += [(serving_case(name), name) for name in SERVING]
    worst = 0.0
    kernels = {}
    for dtype in (torch.float32, torch.bfloat16):
        for (b, t, h, kh, d, splits, kv_block, lengths), serving in cases:
            if serving and dtype == torch.float32:
                continue                    # the caches are bf16
            q, k, v, lens = _decode_inputs(rng, b, t, h, kh, d, lengths,
                                           dtype)
            before = da.decode_attention_cuda.launches
            got = ops.decode_attention(q, k, v, lens, splits=splits,
                                       kv_block=kv_block)
            torch.cuda.synchronize()
            if da.decode_attention_cuda.launches != before + 1:
                raise AssertionError("ops.decode_attention did not launch K4")
            want = da.decode_attention_plain(q, k, v, lens, splits=splits,
                                             kv_block=kv_block)
            err = _verdict("decode_attention", got, want, *TOL[dtype],
                           dtype=str(dtype), shape=[b, t, h, kh, d],
                           lengths=lens.tolist(), splits=splits,
                           kv_block=kv_block)
            if serving:
                worst = max(worst, err)
                # one kernel on the card a call: the splits combine in
                # their cluster
                kernels[serving] = names = _build.graph_kernels(
                    lambda: ops.decode_attention(q, k, v, lens, splits=splits,
                                                 kv_block=kv_block))
                if len(names) != 1:
                    raise AssertionError(f"ops.decode_attention ran {names}")
    say("check", kernel="decode_attention", kernels_per_call=kernels, ok=True)
    return worst, kernels


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


def decode_bound(b, t, h, kh, d, lengths):
    """Least time for bf16 decode attention: q, the cache's k and v, and
    lengths read once, the output written once; 4*D flops (two products)
    per query row and valid key, at the bf16 tensor-core rate."""
    keys = int(torch.clamp(lengths, 0, t).sum())
    return bound(4 * d * h * keys,
                 2 * (2 * b * h * d + 2 * b * t * kh * d) + 4 * b)


def time_flash():
    """K3 at qwen3's S=1024 and 4096 (D=128), recurrentgemma's S=1024
    (D=256, window 2048) and phi-3-vision's prefill (B=4, S=1024, D=96), by
    CUDA events over back-to-back calls (host
    launch cost included), and K3's and SDPA's device time a call inside a
    CUDA graph."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rng = gen(3)
    rows = {}
    for path, (b, s, h, kh, d, window) in (
            ("d128", (1, 1024, 16, 8, 128, None)),
            ("d128_4096", (1, 4096, 16, 8, 128, None)),
            ("d256", (1, 1024, 16, 1, 256, HYBRID_WINDOW)),
            ("d96", (*PHI3_PREFILL, None))):
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
        row["graph_device_ms"] = {
            "kernel": graph_ms(lambda: fa.flash_attention_cuda(
                q, k, v, causal=True, window=window)),
            "library": graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))}
        say("time", kernel="flash_attention", dtype="bf16",
            shape=[b, s, h, kh, d], window=window, library="SDPA", **row)
        rows[path] = row
    return rows


def time_ssd():
    """K5 at mamba2-2.7b's full width, bf16 x/B/C as in serving, at the
    serving prefill buckets S = 256, 512, 768 (chunk 256) and S = 1024: by
    CUDA events over back-to-back calls (host launch cost included) and by
    device time a call inside a CUDA graph; its plain version; the kernels
    a call (from a CUDA-graph capture). Returns the rows by S."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd
    rows = {}
    for s in (256, 512, 768, 1024):
        shape = (1, s, 80, 64, 1, 128)
        args = _ssd_inputs((*shape, 256), torch.bfloat16)
        bound_ms, bound_by = ssd_bound(*shape, 256)
        row = dict(
            ms=event_ms(lambda: ssd.ssd_scan_cuda(*args, chunk=256), 50),
            plain_ms=event_ms(lambda: ssd.ssd_scan_plain(*args, chunk=256),
                              3, 1),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        row["graph_device_ms"] = graph_ms(
            lambda: ssd.ssd_scan_cuda(*args, chunk=256))
        row["kernels_per_call"] = _build.graph_kernels(
            lambda: ssd.ssd_scan_cuda(*args, chunk=256))
        if len(row["kernels_per_call"]) != ssd.BF16_KERNELS:
            raise AssertionError(f"K5 ran {row['kernels_per_call']}")
        say("time", kernel="ssd_scan", dtype="bf16", shape=list(shape),
            chunk=256,
            library="none: no single PyTorch call computes the SSD scan",
            **row)
        rows[s] = row
    return rows


def time_decode():
    """K4 at both serving caches with lengths = T: the kernel through its
    entry point ``ops.decode_attention``, its plain version, ``layers.attend`` on the same cache as decode calls it, and
    SDPA with a boolean length mask (a yardstick the port never calls), by
    CUDA events over back-to-back calls (host launch cost included); and
    the kernel's, attend's and SDPA's device time a call inside a CUDA
    graph."""
    import torch.nn.functional as F
    from decode_attention_cases import SERVING
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    rng = gen(10)
    rows = {}
    for path, (b, t, h, kh, d) in SERVING.items():
        q, k, v, lens = _decode_inputs(rng, b, t, h, kh, d, [t] * b,
                                       torch.bfloat16)
        q_pos = (lens - 1)[:, None]
        k_pos = torch.arange(t, device=DEV)
        qt = q[:, :, None]                              # (B,H,1,D)
        kt = k.transpose(1, 2).contiguous()             # (B,KH,T,D)
        vt = v.transpose(1, 2).contiguous()
        mask = (k_pos[None, :] < lens[:, None])[:, None, None, :]
        bound_ms, bound_by = decode_bound(b, t, h, kh, d, lens)
        row = dict(
            ms=event_ms(lambda: ops.decode_attention(q, k, v, lens), 200),
            plain_ms=event_ms(lambda: da.decode_attention_plain(
                q, k, v, lens), 20),
            attend_ms=event_ms(lambda: layers.attend(
                q[:, None], k, v, q_pos, k_pos), 50),
            library_ms=event_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 50),
            bound_ms=bound_ms, bound_by=bound_by)
        row["graph_device_ms"] = {
            "kernel": graph_ms(lambda: ops.decode_attention(q, k, v, lens)),
            "attend": graph_ms(lambda: layers.attend(
                q[:, None], k, v, q_pos, k_pos)),
            "library": graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))}
        say("time", kernel="decode_attention", dtype="bf16",
            shape=[b, t, h, kh, d], lengths="T", library="SDPA, bool mask",
            **row)
        rows[path] = row
    return rows


def time_rglru():
    """K6 at recurrentgemma-9b's full width, at the serving prefill buckets
    S = 256, 512, 768 and at S = 1024: by CUDA events over back-to-back
    calls (host launch cost included) and by device time a call inside a
    CUDA graph; its plain version; the kernels a call (from a CUDA-graph
    capture); and, as a yardstick of the rate an elementwise pass reaches
    on this card, the device time of ``torch.add(a, b, out=h)``, which
    moves the same bytes (reads a and b, writes h) but computes no
    recurrence. Returns the rows by S."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as rg
    rows = {}
    for s in (256, 512, 768, 1024):
        a, bb = _rglru_inputs(gen(5), 1, s, 4096)
        out = torch.empty_like(a)
        bound_ms, bound_by = rglru_bound(1, s, 4096)
        row = dict(ms=event_ms(lambda: rg.rglru_scan_cuda(a, bb), 50),
                   plain_ms=event_ms(lambda: rg.rglru_scan_plain(a, bb), 3,
                                     1),
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        row["graph_device_ms"] = graph_ms(lambda: rg.rglru_scan_cuda(a, bb))
        row["same_bytes_add_graph_device_ms"] = graph_ms(
            lambda: torch.add(a, bb, out=out))
        row["kernels_per_call"] = _build.graph_kernels(
            lambda: rg.rglru_scan_cuda(a, bb))
        if len(row["kernels_per_call"]) != 1:
            raise AssertionError(f"K6 ran {row['kernels_per_call']}")
        say("time", kernel="rglru_scan", dtype="f32", shape=[1, s, 4096],
            tiles=dict(zip(("tile", "stages"),
                           rg.kernel_tiles(s))),
            library="none: no single PyTorch call computes a linear "
                    "recurrence", **row)
        rows[s] = row
    return rows


# ---------------------------------------------------------------------------
# Phases 3 and 4 for the admission path: the policy-score kernels K1 and K2
# ---------------------------------------------------------------------------


def _policy_inputs(c):
    from repro_torch.kernels import policy_score as ps
    from policy_score_cases import (
        FUSED_ARGS, PREBUILT_ARGS, prebuilt_columns)
    m = prebuilt_columns(c)
    fused = [ps.as_tensor(c[k], DEV) for k in FUSED_ARGS]
    cols = [ps.as_tensor(m[k], DEV) for k in PREBUILT_ARGS]
    # K2's kernel takes the energy column already weighted, as its
    # wrapper hands it over
    wenergy = ps.weight_f32(c["energy_weight"]) * cols[3]
    return fused, cols, wenergy


def check_policy_score() -> float:
    """K1 and K2 against their plain versions on the card, bit-equal choice
    and ok, over every shape, case kind and energy weight. Returns the
    largest |choice difference| (0 when they agree)."""
    from repro_torch.kernels import policy_score as ps
    from policy_score_cases import KINDS, make_case
    cases = mismatches = 0
    worst = 0
    for (f, p) in POLICY_SHAPES:
        for kind in KINDS:
            for i, w in enumerate(POLICY_WEIGHTS):
                c = make_case(97 * f + p + i, f, p, kind, w)
                w = c["energy_weight"]
                fused, cols, wenergy = _policy_inputs(c)
                for name, got, want in (
                        ("K1", ps.fused_composite_decide_cuda(*fused, w),
                         ps.fused_composite_decide(*fused, w)),
                        ("K2", ps.composite_decide_cuda(
                            *cols[:3], wenergy, *cols[4:]),
                         ps.composite_decide(*cols, w))):
                    torch.cuda.synchronize()
                    cases += 1
                    bad = int((got[0] != want[0]).sum()
                              + (got[1] != want[1]).sum())
                    worst = max(worst, int((got[0] - want[0]).abs().max()))
                    if bad:
                        mismatches += 1
                        say("check", kernel=name, shape=[f, p], kind=kind,
                            energy_weight=w, mismatched_rows=bad, ok=False)
    say("check", kernel="policy_score (K1, K2)", cases=cases,
        mismatches=mismatches, shapes=POLICY_SHAPES, weights=POLICY_WEIGHTS,
        kinds=list(KINDS), rule="bit-equal choice and ok",
        ok=mismatches == 0)
    if mismatches:
        raise AssertionError(f"policy-score kernels disagree with their "
                             f"plain versions in {mismatches} of {cases} "
                             f"cases")
    return float(worst)


def policy_bound(f: int, p: int, fused: bool):
    """Least time for one decision on the card: every input read once and
    the outputs written once; ~6 f32 operations a cell for K1 (1.5 * exec,
    two energy products, the weight product, two adds), 2 for K2 (two
    adds), at the f32 rate outside the tensor cores."""
    cell = (4 * 4 + 2 * 4 + 1) if fused else (4 * 4 + 1)
    vec = (4 + 4 + 1) if fused else 1
    nbytes = f * p * cell + p * vec + f * 4 + f * (4 + 1)
    return bound((6 if fused else 2) * f * p, nbytes, PEAK_F32_FLOPS)


def time_policy_score():
    """K1 and K2 at the admission path's shapes and the registry-scale one:
    kernel and plain version on the card by CUDA events over back-to-back
    calls (at the path's tiny shapes that reads the host's launch rate),
    and the kernel's device time per launch inside a CUDA graph. No single
    PyTorch call computes a degraded cascade with a lowest-index argmin, so
    there is no library time."""
    from repro_torch.kernels import policy_score as ps
    from policy_score_cases import make_case
    rows = {}
    for (f, p) in POLICY_TIMED:
        c = make_case(11 + f + p, f, p, "random", 0.1)
        fused, cols, wenergy = _policy_inputs(c)
        iters = 1000 if f * p < 1000 else 100
        for name, kernel, plain, is_fused in (
                ("fused_composite_decide",
                 lambda: ps.fused_composite_decide_cuda(*fused, 0.1),
                 lambda: ps.fused_composite_decide(*fused, 0.1), True),
                ("composite_decide",
                 lambda: ps.composite_decide_cuda(*cols[:3], wenergy,
                                                  *cols[4:]),
                 lambda: ps.composite_decide(*cols, 0.1), False)):
            bound_ms, bound_by = policy_bound(f, p, is_fused)
            row = dict(ms=event_ms(kernel, iters, 10),
                       plain_ms=event_ms(plain, iters // 10, 5),
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            row["graph_device_ms"] = graph_ms(kernel)
            say("time", kernel=name, shape=[f, p], iters=iters,
                library="none (no single call)", **row)
            rows[(name, f, p)] = row
    return rows


def _fleet(rng, names, fns):
    """tests/test_admission_fastpath.py's randomized platform state, in the
    port, on the card: ``names`` of the paper platforms with random
    background load and random observed executions of every function."""
    from repro_torch.core import FDNControlPlane, profiles
    from repro_torch.core import functions as fn_mod
    from repro_torch.core.loadgen import attach_completion_hooks
    from repro_torch.core.types import DeploymentSpec, Invocation
    cp = FDNControlPlane()
    for n in names:
        cp.create_platform(profiles.PAPER_PLATFORMS[n])
    fn_mod.seed_object_stores(cp.placement, location="cloud-cluster",
                              device=DEV)
    cp.deploy(DeploymentSpec("t", list(fns.values()), list(cp.platforms)))
    attach_completion_hooks(cp)
    for p in cp.platforms.values():
        p.bg_cpu = float(rng.uniform(0, 1.2))
        p.bg_mem = float(rng.uniform(0, 0.8))
    for fn in fns.values():
        for pname in cp.platforms:
            for _ in range(int(rng.integers(0, 15))):
                inv = Invocation(fn, 0.0)
                inv.platform = pname
                inv.exec_time = float(rng.uniform(0.01, 8.0))
                inv.end_t = inv.exec_time
                cp.perf.observe(inv)
    return cp


def _paper_fns():
    from repro_torch.core import functions as fn_mod
    return {k: f.replace(real_fn=None)
            for k, f in fn_mod.paper_functions(device=DEV).items()}


def _decision_fleet(n_fns: int):
    """The admission decision's state for ``n_fns`` functions over the five
    paper platforms (``_fleet``'s randomized state): the paper's five
    functions, repeated under new names past five."""
    from repro_torch.core import profiles
    base = list(_paper_fns().values())
    fns = {}
    for i in range(n_fns):
        spec = base[i % len(base)]
        name = spec.name if i < len(base) else f"{spec.name}-{i}"
        fns[name] = spec.replace(name=name)
    cp = _fleet(gen(8), list(profiles.PAPER_PLATFORMS), fns)
    return cp, list(fns.values())


def _host_ms(fn, iters: int) -> float:
    """Host ms a call of ``fn``, which ends with its result on the host."""
    import time as _time
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = _time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (_time.perf_counter() - t0) / iters * 1e3


def time_decision():
    """The admission decision as the path makes it, F functions over the
    P=5 paper platforms, for each F of ``DECISION_FNS``: a fresh snapshot
    and one ``fn_decisions`` per call, host clock (each call ends with the
    choice on the host), under each backend (the median of three turns),
    the choices identical; torch with K1 runs on K1's pinned staging
    block. At F=5 also K1's staged
    route alone (host arrays in, choice out). Returns the F=5 row and the
    table."""
    from repro_torch.core import scheduler as sched
    from repro_torch.kernels import policy_score as ps
    table = []
    sched.set_score_device(DEV)
    try:
        for n_fns in DECISION_FNS:
            cp, specs = _decision_fleet(n_fns)
            pol = sched.SLOCompositePolicy(cp.perf, cp.placement)
            plats = cp.alive_platforms()

            def decide():
                return pol.fn_decisions(specs, sched.as_snapshot(plats))

            iters = 2000 if n_fns == 5 else max(100, 2000 // n_fns)
            row, picks = dict(F=len(specs), P=len(plats), iters=iters), {}
            times = {}
            for _ in range(3):              # the backends in turn, 3 times
                for label, backend, kernel in (("numpy", "numpy", False),
                                               ("torch", "torch", False),
                                               ("torch_k1", "torch", True)):
                    sched.set_score_backend(backend)
                    ps.set_use_pallas(kernel)
                    times.setdefault(label, []).append(_host_ms(decide,
                                                                iters))
                    picks[label] = [a.tolist() for a in decide()]
            for label, ms in times.items():
                row[f"{label}_ms"] = float(np.median(ms))
            if not picks["numpy"] == picks["torch"] == picks["torch_k1"]:
                raise AssertionError(f"decision backends disagree at F="
                                     f"{n_fns}: {picks}")
            if n_fns == 5:
                host = pol._fused_inputs(specs, sched.as_snapshot(plats))
                w = pol.energy_weight
                row["k1_staged_route_ms"] = _host_ms(
                    lambda: ps.fused_composite_decide_staged(
                        *host, w, device=DEV), iters)
            say("time", what="admission decision",
                clock="host, fresh snapshot per decision", **row)
            table.append(row)
    finally:
        sched.set_score_backend("auto")
        ps.set_use_pallas(False)
        sched.set_score_device(None)
    beats = [r["F"] for r in table if r["torch_k1_ms"] < r["numpy_ms"]]
    say("time", what="admission decision crossover",
        functions=[r["F"] for r in table],
        torch_k1_beats_numpy_at=beats)
    return next(r for r in table if r["F"] == 5), table


# ---------------------------------------------------------------------------
# The warm-pool forecaster's tick on the card (torch ops: the JAX package's
# tick is jax.jit, not Pallas, so no hand-written kernel replaces it)
# ---------------------------------------------------------------------------

FORECAST_STREAMS = ((3, 9, 300), (5, 4096, 200))
FORECAST_ROWS = (25, 256, 4096, 65536)


def _forecast_stream(seed, rows, ticks):
    """tests/test_autoscale.py's seeded arrival stream and exec seconds."""
    rng = gen(seed)
    bursts = rng.poisson(3.0, size=(ticks, rows)) * \
        (rng.random(size=(ticks, rows)) < 0.25)
    return bursts, rng.uniform(0.02, 0.8, rows)


def check_forecast():
    """Phase 3, forecaster. The gap bucket on the card at every power of
    two and one below it against NumPy's ``floor(log2)`` (the route by
    exponent, which the tick takes, must agree; the ``log2`` route's misses
    are printed for the record), then the predictive policy's decisions
    with the tick on the card byte-equal to the NumPy oracle's on the
    reference test's seeded stream (seed 3, 9 rows, 300 ticks) and at 4,096
    rows."""
    from repro_torch.autoscale import PredictivePolicy
    from repro_torch.autoscale import forecast as fc
    from repro_torch.kernels import warm_forecast as wf
    idle = np.array([2.0 ** k for k in range(13)]
                    + [2.0 ** k - 1 for k in range(2, 13)] + [0.0, 3.0])
    want = np.clip(np.floor(np.log2(np.maximum(idle, 1.0))), 0, 11)
    t = torch.tensor(idle, dtype=torch.float32, device=DEV)
    got = wf.gap_bucket(t, 12).cpu().numpy()
    via_log2 = torch.clamp(torch.floor(torch.log2(torch.clamp_min(t, 1.0))),
                           0, 11).cpu().numpy()
    log2_misses = [float(x) for x, a, b in zip(idle, via_log2, want)
                   if a != b]
    if got.tolist() != want.astype(int).tolist():
        raise AssertionError(f"gap buckets on the card {got.tolist()} != "
                             f"NumPy's {want.astype(int).tolist()}")
    out = {"bucket_cases": len(idle), "log2_route_misses": log2_misses}
    for seed, rows, ticks in FORECAST_STREAMS:
        bursts, exec_s = _forecast_stream(seed, rows, ticks)
        traces, torch_ticks = {}, 0
        for backend in ("numpy", "torch"):
            with fc.forecast_settings(backend, DEV):
                pol = PredictivePolicy(backend=backend)
                pol.resize(rows)
                pol.set_exec(exec_s, 1.0)
                trace = []
                for k in range(ticks):
                    counts = bursts[k].astype(float)
                    desired, ttl = pol.tick(counts, bool(counts.any()))
                    trace.append((desired.tobytes(), ttl.tobytes()))
                traces[backend] = trace
                torch_ticks += pol.torch_ticks
        if torch_ticks != int(bursts.any(axis=1).sum()) or torch_ticks == 0:
            raise AssertionError(f"forecaster stream {seed}/{rows}: "
                                 f"{torch_ticks} torch ticks")
        if traces["torch"] != traces["numpy"]:
            bad = sum(a != b for a, b in zip(traces["torch"],
                                             traces["numpy"]))
            raise AssertionError(f"forecaster stream {seed}/{rows}: the "
                                 f"card's decisions differ from NumPy's at "
                                 f"{bad} of {ticks} ticks")
        out[f"stream_{seed}_{rows}"] = dict(ticks=ticks,
                                            torch_ticks=torch_ticks,
                                            decisions_equal=True)
    say("forecast", check="tick on the card against NumPy", **out, ok=True)


def time_forecast():
    """Phase 4, forecaster. Host ms a forecaster tick (state and arrival
    counts in, decisions on the host) at ``FORECAST_ROWS`` managed rows,
    the NumPy tick against the torch tick on the card, turn by turn (the
    median of three turns), over a seeded 16-tick arrival cycle so that gap
    histograms fill as on a real stream."""
    from repro_torch.autoscale import forecast as fc
    p = fc.ForecastParams()
    table = []
    fc.set_forecast_device(DEV)
    try:
        for rows in FORECAST_ROWS:
            bursts, exec_s = _forecast_stream(31, rows, 16)
            bursts = bursts.astype(float)
            bursts[:, 0] += 1.0           # every tick has an arrival
            coeff = exec_s * p.headroom
            ticks = {}
            for backend in ("numpy", "torch"):
                st = fc.ForecastState(p.n_buckets)
                st.resize(rows)
                bufs = dict(desired=np.zeros(rows), scratch=np.zeros(rows),
                            ttl=np.full(rows, p.default_ttl_ticks),
                            hold=np.zeros(rows, dtype=bool))
                k = [0]

                def tick(backend=backend, st=st, bufs=bufs, k=k):
                    counts = bursts[k[0] % 16]
                    k[0] += 1
                    if backend == "numpy":
                        fc.predictive_tick_numpy(
                            st, counts, coeff, p, True, bufs["desired"],
                            bufs["scratch"], bufs["ttl"], bufs["hold"],
                            hold_thr=p.hold_min_rps)
                    else:
                        fc.predictive_tick_torch(
                            st, counts, coeff, p, bufs["desired"],
                            bufs["ttl"], hold_thr=p.hold_min_rps)
                ticks[backend] = tick
            iters = 30 if rows >= 65536 else (200 if rows >= 4096 else 500)
            times = {"numpy": [], "torch": []}
            for _ in range(3):
                for backend, tick in ticks.items():
                    times[backend].append(_host_ms(tick, iters))
            row = dict(rows=rows, iters=iters,
                       numpy_ms=float(np.median(times["numpy"])),
                       torch_ms=float(np.median(times["torch"])),
                       numpy_turns=times["numpy"], torch_turns=times["torch"],
                       torch_leads_every_turn=all(
                           t < n for t, n in zip(times["torch"],
                                                 times["numpy"])))
            say("time", what="forecaster tick", clock="host", **row)
            table.append(row)
    finally:
        fc.set_forecast_device(None)
    say("time", what="forecaster tick crossover",
        rows=[r["rows"] for r in table],
        torch_leads_every_turn_at=[r["rows"] for r in table
                                   if r["torch_leads_every_turn"]],
        torch_forecast_min=fc.TORCH_FORECAST_MIN)


POLICY_FACTORIES = {
    "perf_ranked": lambda s, cp: s.PerformanceRankedPolicy(cp.perf),
    "utilization": lambda s, cp: s.UtilizationAwarePolicy(
        cp.perf, cpu_threshold=0.7),
    "round_robin": lambda s, cp: s.RoundRobinCollaboration(),
    "weighted": lambda s, cp: s.WeightedCollaboration(
        {"hpc-node-cluster": 5, "cloud-cluster": 1, "edge-cluster": 2}),
    "data_locality": lambda s, cp: s.DataLocalityPolicy(cp.perf,
                                                        cp.placement),
    "warm_aware": lambda s, cp: s.WarmAwarePolicy(cp.perf, cp.placement),
    "energy": lambda s, cp: s.EnergyAwarePolicy(cp.perf),
    "slo_composite": lambda s, cp: s.SLOCompositePolicy(cp.perf,
                                                        cp.placement),
}


def policy_parity(trials: int = 4, n_invs: int = 96):
    """Phase 5a. tests/test_admission_fastpath.py:82-101's scenarios on the
    card: every policy picks the same platforms under the numpy backend,
    the torch backend and torch with the kernel."""
    from repro_torch.core import profiles
    from repro_torch.core import scheduler as sched
    from repro_torch.core.types import SLO, Invocation
    from repro_torch.kernels import policy_score as ps
    fns = _paper_fns()
    rng = gen(20260730)
    all_names = list(profiles.PAPER_PLATFORMS)
    decisions = k1_decisions = 0
    sched.set_score_device(DEV)
    torch.cuda.synchronize()
    ps.fused_composite_decide_cuda.launches = 0
    try:
        for trial in range(trials):
            k = int(rng.integers(2, len(all_names) + 1))
            names = list(rng.choice(all_names, size=k, replace=False))
            cp = _fleet(rng, names, fns)
            specs = [s if rng.random() < 0.5 else s.replace(slo=SLO(
                p90_response_s=float(rng.uniform(0.05, 10))))
                for s in fns.values()]
            mix = [specs[int(rng.integers(0, len(specs)))]
                   for _ in range(n_invs)]
            plats = list(cp.platforms.values())
            for pname, make in POLICY_FACTORIES.items():
                picks = {}
                for label, backend, kernel in (("numpy", "numpy", False),
                                               ("torch", "torch", False),
                                               ("torch_k1", "torch", True)):
                    sched.set_score_backend(backend)
                    ps.set_use_pallas(kernel)
                    pol = make(sched, cp)        # fresh rotation state
                    got = pol.choose_batch([Invocation(f, 0.0) for f in mix],
                                           plats)
                    picks[label] = [p.prof.name if p else None for p in got]
                    decisions += pol.torch_decisions
                    if kernel and pname == "slo_composite":
                        k1_decisions += pol.torch_decisions
                if not picks["numpy"] == picks["torch"] == picks["torch_k1"]:
                    raise AssertionError(f"{pname} trial {trial}: backends "
                                         f"pick different platforms")
    finally:
        sched.set_score_backend("auto")
        ps.set_use_pallas(False)
        sched.set_score_device(None)
    k1_launches = ps.fused_composite_decide_cuda.launches
    ok = k1_decisions > 0 and k1_launches == k1_decisions
    say("parity", trials=trials, invocations=n_invs,
        policies=list(POLICY_FACTORIES),
        backends=["numpy", "torch", "torch+K1"], torch_decisions=decisions,
        k1_decisions=k1_decisions, k1_launches=k1_launches, ok=ok)
    if not ok:
        raise AssertionError(f"torch+K1 made {k1_decisions} slo_composite "
                             f"decisions but K1 launched {k1_launches} "
                             f"times")


def admission_stream() -> dict:
    """Phase 5b. The 100,000-arrival stream three ways; returns the K1 run's
    kernel launches."""
    from repro_torch.launch.batch_scheduling import run
    keys = ("arrivals", "completed", "rejected", "platform_counts",
            "p90_response_s", "cold_starts")
    runs = {}
    launches = None
    for label, backend, kernel in (("numpy", "numpy", False),
                                   ("torch", "torch", False),
                                   ("torch_k1", "torch", True)):
        kernels = wrappers()
        if kernel:
            torch.cuda.synchronize()
            for fn in kernels.values():
                fn.launches = 0
        out = run(STREAM_ARRIVALS, backend, kernel, DEV)
        if kernel:
            launches = {name: fn.launches for name, fn in kernels.items()}
        del out["sink"], out["cp"]
        say("admission", run=label, **out)
        runs[label] = out
    want = {k: runs["numpy"][k] for k in keys}
    for label in ("torch", "torch_k1"):
        got = {k: runs[label][k] for k in keys}
        if got != want:
            raise AssertionError(f"admission stream under {label} differs "
                                 f"from numpy: {got} != {want}")
    k1 = runs["torch_k1"]
    if not (k1["torch_decisions"] > 0
            and launches["fused_composite_decide"] == k1["torch_decisions"]
            and sum(launches.values()) == k1["torch_decisions"]):
        raise AssertionError(f"K1 launches {launches} != torch decisions "
                             f"{k1['torch_decisions']}")
    if runs["torch"]["k1_launches"] != 0:
        raise AssertionError("the torch run without the kernel launched K1")
    say("admission", launches=launches,
        torch_decisions=k1["torch_decisions"], identical=list(keys), ok=True)
    return launches


# The Inspector's registry scenarios: the seven with a golden in
# benchmarks/golden/ and prov/smoke-tiny, at their registered sizes; the runs
# of each (label, decision backend, K1, forecaster backend); and whether
# their K1 run must launch K1 (once a torch decision). Each decides a few
# distinct functions at a time, far below TORCH_DECIDE_MIN, so the torch runs
# set the backend to "torch", not "auto". paper/fig10-weighted's gateway
# routes every invocation through its weighted load balancer, and the
# autoscale arms run one platform named by platform_override: the composite
# policy decides nothing there, and K1 must launch exactly 0 times. The
# autoscale arms manage one row, below TORCH_FORECAST_MIN, so their torch
# run forces the forecaster to torch on the card; -predictive's must tick
# there (the fixed TTL of -ttl has no forecaster). telemetry/hpc-outage runs
# K1 under the telemetry engine, prov/smoke-tiny under the decision journal,
# whose same-policy replay must reproduce every journaled choice.
THREE_WAYS = (("numpy", "numpy", False, "numpy"),
              ("torch", "torch", False, "numpy"),
              ("torch_k1", "torch", True, "numpy"))
FORECAST_WAYS = (("numpy", "numpy", False, "numpy"),
                 ("torch_k1", "torch", True, "torch"))
INSPECTOR_SCENARIOS = {"smoke/tiny": (THREE_WAYS, True),
                       "paper/fig10-weighted": (THREE_WAYS, False),
                       "qos/burst-storm-drr": (THREE_WAYS, True),
                       "chains/etl-pipeline": (THREE_WAYS, True),
                       "autoscale/diurnal-predictive": (FORECAST_WAYS, False),
                       "autoscale/diurnal-ttl": (FORECAST_WAYS, False),
                       "telemetry/hpc-outage": (THREE_WAYS, True),
                       "prov/smoke-tiny": (THREE_WAYS, True)}


def inspector() -> dict:
    """Phase 5c. The Inspector's scenarios (``INSPECTOR_SCENARIOS``) through
    ``repro_torch.launch.inspector_scenario``: byte-identical reports across
    the runs, every kernel's launch count set to 0 just before each run and
    read just after (K1's equal to the K1 run's torch decisions, every other
    count 0), the forecaster's torch ticks counted, the journal's replay
    oracle held, and each report with a golden without drift against it by
    ``benchmarks/scenario_diff.diff_reports``. Returns K1's launches by
    scenario."""
    from benchmarks.scenario_diff import diff_reports
    from repro_torch.launch.inspector_scenario import run
    from repro_torch.obs import replay_matches
    k1_launches = {}
    for name, (ways, decides) in INSPECTOR_SCENARIOS.items():
        reports = {}
        for label, backend, kernel, forecaster in ways:
            kernels = wrappers()
            torch.cuda.synchronize()
            for fn in kernels.values():
                fn.launches = 0
            out = run(name, backend, kernel, DEV, forecaster)
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in kernels.items()}
            rep = out["report"]
            t = rep.totals
            n = out["torch_decisions"]
            journal = out["state"].control_plane.journal
            replay_ok = None if journal is None else replay_matches(journal)
            auto = out["scenario"].autoscale
            say("inspector", scenario=name, run=label, wall_s=out["wall_s"],
                decisions=t["decisions"], torch_decisions=n,
                host_ms_per_decision=out["wall_s"] * 1e3
                / max(t["decisions"], 1),
                completed=t["completed"], rejected=t["rejected"],
                p90_s=t["p90_s"], cold_starts=t["cold_starts"],
                chains_completed=t.get("chains_completed"),
                forecaster=forecaster if auto else None,
                autoscale_ticks=t["autoscale"]["ticks"] if auto else None,
                torch_forecaster_ticks=out["torch_ticks"],
                journal_rows=None if journal is None else journal.n,
                replay_matches=replay_ok, launches=launches)
            want = {k: 0 for k in launches}
            if kernel:
                want["fused_composite_decide"] = n
                k1_launches[name] = launches["fused_composite_decide"]
                if (n > 0) != decides:
                    raise AssertionError(
                        f"{name}: {n} torch decisions under torch+K1; "
                        f"expected {'some' if decides else 'none'}")
            if launches != want:
                raise AssertionError(f"{name} under {label}: kernel "
                                     f"launches {launches} != {want}")
            ticks_want = bool(auto and forecaster == "torch"
                              and auto["policy"] == "predictive")
            if (out["torch_ticks"] > 0) != ticks_want:
                raise AssertionError(f"{name} under {label}: "
                                     f"{out['torch_ticks']} torch forecaster "
                                     f"ticks")
            if replay_ok is False:
                raise AssertionError(f"{name} under {label}: the same-policy "
                                     f"replay diverged from the journal")
            reports[label] = rep.to_json()
        for label in reports:
            if reports[label] != reports["numpy"]:
                raise AssertionError(f"{name}: the report under {label} "
                                     f"differs from numpy's")
        path = (ROOT / "benchmarks" / "golden"
                / f"{name.replace('/', '_')}.json")
        drift = (diff_reports(json.loads(reports["numpy"]),
                              json.loads(path.read_text()))
                 if path.exists() else [])
        say("inspector", scenario=name, identical=list(reports),
            report_bytes=len(reports["numpy"]),
            golden=path.name if path.exists() else None,
            golden_drift=[str(d) for d in drift], ok=not drift)
        if drift:
            raise AssertionError(f"{name}: drift against its golden: "
                                 f"{drift}")
    return k1_launches


@contextlib.contextmanager
def pinned_bodies():
    """``ExecutionModel.measure_real`` replaced by the tests' fixed seconds
    per function (``tests/example_pins.py``) for the block: the examples
    time their real bodies once on the host's clock otherwise, so two runs
    print the same bytes only when their host was equally loaded."""
    from example_pins import pinned_measure_real
    from repro_torch.core.platform import ExecutionModel
    saved = ExecutionModel.measure_real
    ExecutionModel.measure_real = pinned_measure_real
    try:
        yield
    finally:
        ExecutionModel.measure_real = saved


def _example_run(run, label, bodies, backend, kernel):
    """One run of a twin with every kernel's launch count set to 0 just
    before it and read just after; K1's launches must equal the run's
    torch decisions under the kernel, every other count 0."""
    import time
    kernels = wrappers()
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = run(backend, device=DEV, **({"kernel": True} if kernel else {}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    example = run.__module__.rsplit(".", 1)[1]
    n = out["torch_decisions"]
    say("examples", example=example, run=label, bodies=bodies, wall_s=wall,
        launches=launches, **out)
    want = {k: 0 for k in launches}
    if kernel and example == "serve_fdn":
        want["fused_composite_decide"] = n
    if (n > 0) != (backend == "torch"):
        raise AssertionError(f"{example} under {label}: {n} torch "
                             f"decisions")
    if launches != want:
        raise AssertionError(f"{example} under {label}: kernel launches "
                             f"{launches} != {want}")
    return out


def examples() -> int:
    """Phase 5d. The twins of examples/serve_fdn.py (hedging and predictive
    prewarming on, every invocation through ``Gateway.request``) and
    examples/energy_aware_scheduling.py (Table 4). With the bodies pinned
    (``pinned_bodies``): serve_fdn three ways (numpy, torch, torch with K1)
    and energy_aware_scheduling two ways (numpy, torch), each twin's
    printed report byte-identical across its runs. Then each once with
    its real bodies on the card, their measured seconds printed. Returns
    K1's launches in the pinned K1 run of serve_fdn."""
    from repro_torch.launch import energy_aware_scheduling, serve_fdn
    k1 = None
    with pinned_bodies():
        for twin, ways in ((serve_fdn, THREE_WAYS),
                           (energy_aware_scheduling, THREE_WAYS[:2])):
            reports = {}
            for label, backend, kernel, _ in ways:
                out = _example_run(twin.run, label, "pinned", backend,
                                   kernel)
                reports[label] = twin.report(out)
                if twin is serve_fdn and kernel:
                    k1 = out["k1_launches"]
            for label in reports:
                if reports[label] != reports["numpy"]:
                    raise AssertionError(
                        f"{twin.__name__}: the report under {label} "
                        f"differs from numpy's:\n{reports[label]}\n"
                        f"{reports['numpy']}")
            say("examples", example=twin.__name__.rsplit(".", 1)[1],
                identical=list(reports), report=reports["numpy"], ok=True)
    for twin, kernel in ((serve_fdn, True), (energy_aware_scheduling, False)):
        out = _example_run(twin.run, "torch_k1" if kernel else "torch",
                           "real", "torch", kernel)
        print(twin.report(out), end="", flush=True)
    return k1


# ---------------------------------------------------------------------------
# Phases 6 and 7: serve each model; logits
# ---------------------------------------------------------------------------


def wrappers():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import policy_score as ps
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ssd
    return {"flash_attention": fa.flash_attention_cuda,
            "decode_attention": da.decode_attention_cuda,
            "ssd_scan": ssd.ssd_scan_cuda, "rglru_scan": rg.rglru_scan_cuda,
            "fused_composite_decide": ps.fused_composite_decide_cuda,
            "composite_decide": ps.composite_decide_cuda}


def per_prefill(cfg) -> dict:
    """Each kernel's launches in one prefill of ``cfg``'s path. Decode runs
    ``layers.attend``, so K4 launches 0 times in a serving run: ``serve``
    asserts that, which shows that no route to it was added."""
    from repro_torch.models import rglru
    n = {name: 0 for name in wrappers()}
    if cfg.family in ("dense", "moe", "vlm"):
        n["flash_attention"] = cfg.num_layers
    elif cfg.family == "ssm":
        n["ssd_scan"] = cfg.num_layers
    elif cfg.family == "hybrid":       # 2 recurrent blocks a super, + tail
        n["flash_attention"] = rglru.n_super(cfg)
        n["rglru_scan"] = 2 * rglru.n_super(cfg) + rglru.n_tail(cfg)
    return n


def serve(cfg, params, n_req: int = 16) -> dict:
    """Phase 6. Returns each kernel's launch count over the measured run."""
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


def logits_parity(cfg, params, batch=None):
    """Phase 7. Last-token prefill logits through the kernels, through the
    plain route (``use_pallas=False``), and through the plain route in f32
    weights. The served families take two 1024-token prompts: the dense and
    MoE families' right-padded (300 and 1000 tokens: the engine's ragged
    prefill); the recurrent families read no ``prompt_lens``, so theirs are
    whole. phi-3-vision and whisper-small take ``batch``, their
    ``make_batch`` batch of phase 9.

    Tolerance: both bf16 routes run every layer in bf16 and round at
    different places, so neither equals the f32 run; the kernel route must
    stay as close to it as the plain route does, within 1.5x plus 2**-8 of
    the largest f32 logit (one bf16 rounding at that scale).

    The MoE family's expert choice is discrete: a bf16 rounding that moves
    a near-tie of two router probabilities gives that token another
    expert's whole contribution, in either bf16 route, whatever its
    attention. So its bf16 routes are held against the f32 run with the
    f32 run's expert choices replayed (``_routing``), each route's own
    gates taken at those experts; the unpinned errors and the number of
    (token, layer) choices each route would have flipped are printed
    beside them, not held."""
    from repro_torch.models import model_api as api

    ragged = cfg.family in ("dense", "moe")
    if batch is None:
        rng = gen(6)
        lens = np.array([300, 1000] if ragged else [1024, 1024])
        tokens = np.zeros((2, 1024), np.int64)
        for i, n in enumerate(lens):
            tokens[i, :n] = rng.integers(1, cfg.vocab_size, n)
        batch = {"tokens": torch.from_numpy(tokens).to(DEV)}
        if ragged:
            batch["prompt_lens"] = torch.from_numpy(lens).to(DEV)
    else:
        lens = np.full(batch["tokens"].shape[0], batch["tokens"].shape[1])
    n_rows = len(lens)
    plain_cfg = cfg.replace(use_pallas=False)
    moe = cfg.family == "moe"
    choices, routing = [], {}
    with torch.inference_mode():
        p32 = _tree_float(params)
        with _routing(moe, choices, "record"):
            lf = api.prefill(plain_cfg, p32, batch, 1024)[0].float()
        del p32
        if moe:
            free = {}
            for label, c in (("kernel", cfg), ("plain", plain_cfg)):
                flips = []
                with _routing(moe, choices, "count", flips):
                    free[label] = float((api.prefill(c, params, batch, 1024)[0]
                                         .float() - lf).abs().max())
                routing[f"{label}_flipped_choices"] = sum(flips)
            routing.update(choices=sum(t[..., 0].numel() for t in choices),
                           kernel_vs_f32_unpinned=free["kernel"],
                           plain_vs_f32_unpinned=free["plain"])
        with _routing(moe, choices, "replay"):
            lk = api.prefill(cfg, params, batch, 1024)[0].float()
        with _routing(moe, choices, "replay"):
            lp = api.prefill(plain_cfg, params, batch, 1024)[0].float()
    if (lk.shape != (n_rows, 1, cfg.vocab_size)
            or not torch.isfinite(lk).all()):
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
        same_argmax=bool((lk.argmax(-1) == lp.argmax(-1)).all()),
        **({"routing": "f32 run's experts replayed", **routing}
           if moe else {}))
    if not err_k <= limit:
        raise AssertionError(f"{cfg.name}: kernel-route logits are {err_k} "
                             f"from the f32 run; the plain route's are "
                             f"{err_p}")


@contextlib.contextmanager
def _routing(on: bool, choices: list, mode: str, flips: list = None):
    """Around one MoE prefill (``on``): "record" appends each layer's
    expert choices (top_i) to ``choices``; "count" appends to ``flips`` the
    number of tokens whose set of experts differs from the recorded one, in
    call order; "replay" routes every token to the recorded experts, with
    the gates of the run's own router renormalised over them."""
    from repro_torch.models import moe
    if not on:
        yield
        return
    real, calls = moe.route, iter(choices)

    def route(cfg, p, x):
        probs, top_p, top_i, aux = real(cfg, p, x)
        if mode == "record":
            choices.append(top_i)
            return probs, top_p, top_i, aux
        want = next(calls)
        if mode == "count":
            flips.append(int((top_i.sort(-1).values != want.sort(-1).values)
                             .any(-1).sum()))
            return probs, top_p, top_i, aux
        top_p = probs.gather(-1, want)
        return probs, top_p / top_p.sum(-1, keepdim=True), want, aux

    moe.route = route
    try:
        yield
    finally:
        moe.route = real


def cache_parity(cfg, params) -> int:
    """Phase 8. K4, through ``ops.decode_attention``, on every attention
    layer's cache as ``cfg``'s own prefill builds it (no copy), with ``lengths = cache["pos"]`` and a seeded q: against its
    plain version at ``TOL`` and against ``layers.attend`` (as decode calls
    it, ``k_pos`` from the cache) within ``ATTEND_LIMIT``. qwen3-0.6b
    prefills four right-padded prompts of 64, 300, 700 and 1000 tokens;
    recurrentgemma-9b 1000 tokens, so its local ring (1152 slots) has not
    wrapped. Returns K4's launches, counted from 0 over this phase."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers
    from repro_torch.models import model_api as api

    rng = gen(12)
    if cfg.family == "dense":
        lens = np.array([64, 300, 700, 1000])
        tokens = np.zeros((4, 1024), np.int64)
        for i, n in enumerate(lens):
            tokens[i, :n] = rng.integers(1, cfg.vocab_size, n)
        batch = {"tokens": torch.from_numpy(tokens).to(DEV),
                 "prompt_lens": torch.from_numpy(lens).to(DEV)}
        window = cfg.sliding_window
    else:
        batch = {"tokens": torch.from_numpy(
            rng.integers(1, cfg.vocab_size, (4, 1000))).to(DEV)}
        window = cfg.local_window
    with torch.inference_mode():
        _, cache = api.prefill(cfg, params, batch, 1024)
        pos, k_pos = cache["pos"], cache["k_pos"]
        n_layers = cache["k"].shape[0]
        atol, rtol = TOL[torch.bfloat16]
        worst = dict(plain=0.0, attend=0.0, of_limit=0.0, mean_abs_out=0.0)
        torch.cuda.synchronize()
        da.decode_attention_cuda.launches = 0
        for i in range(n_layers):
            kc, vc = cache["k"][i], cache["v"][i]
            q = on_card(rng.normal(size=(4, cfg.n_heads, cfg.head_dim)),
                        torch.bfloat16)
            got = ops.decode_attention(q, kc, vc, pos).float()
            torch.cuda.synchronize()
            want = da.decode_attention_plain(q, kc, vc, pos).float()
            att = layers.attend(q[:, None], kc, vc, pos[:, None], k_pos,
                                causal=True, window=window)[:, 0].float()
            pv = ref.decode_attention_ref(q.float(), kc.float(),
                                          vc.float().abs(), pos)
            err = float((got - want).abs().max())
            err_att = (got - att).abs()
            of_limit = float((err_att / (ATTEND_LIMIT * (att.abs() + pv)))
                             .max())
            row = dict(plain=err, attend=float(err_att.max()),
                       of_limit=of_limit,
                       mean_abs_out=float(want.abs().mean()))
            worst = {k: max(worst[k], row[k]) for k in worst}
            if not (torch.isfinite(got).all() and of_limit <= 1.0
                    and torch.allclose(got, want, atol=atol, rtol=rtol)):
                raise AssertionError(f"{cfg.name} layer {i}: K4 is {err} from "
                                     f"its plain version and {of_limit} of "
                                     f"the attend limit")
        launches = da.decode_attention_cuda.launches
    say("cache", arch=cfg.name, layers=n_layers, cache=list(cache["k"].shape),
        lengths=pos.tolist(), tol=[atol, rtol], attend_limit=ATTEND_LIMIT,
        max_abs_err_plain=worst["plain"], max_abs_err_attend=worst["attend"],
        max_of_attend_limit=worst["of_limit"],
        max_mean_abs_out=worst["mean_abs_out"], launches=launches,
        ok=launches == n_layers)
    if launches != n_layers:
        raise AssertionError(f"{cfg.name}: K4 launched {launches} times on "
                             f"{n_layers} layers")
    return launches


def _tree_float(tree):
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    return tree.float()


def _keep_layers(tree, n: int):
    """Replace every stacked leaf of ``tree`` by a copy of its first ``n``
    layers, one leaf at a time, so that the card never holds both whole
    trees (a slice view would keep every layer's storage alive)."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            _keep_layers(tree[k], n)
        else:
            tree[k] = tree[k][:n].clone()


def run_model(arch: str):
    """Phases 6, 7 and (for the dense and hybrid families) 8 for one model,
    cut as ``MODELS`` says; frees its weights. Returns the kernel launches
    of its serving run and K4's launches on its caches."""
    from repro_torch import device as devmod
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_api as api
    from repro_torch.models.params import tree_leaves

    dev = devmod.resolve(DEV)
    cfg = get_config(arch).replace(use_pallas=True, **MODELS[arch])
    params = api.init_params(cfg, devmod.generator(0, dev), dev)
    say("model", arch=cfg.name, layers=cfg.num_layers,
        published_layers=get_config(arch).num_layers,
        param_bytes=sum(t.numel() * t.element_size()
                        for t in tree_leaves(params)))
    launches = serve(cfg, params)
    if cfg.family == "moe":
        gc.collect()
        _keep_layers(params["layers"], MOE_PARITY_LAYERS)
        torch.cuda.empty_cache()
        logits_parity(cfg.replace(num_layers=MOE_PARITY_LAYERS), params)
    else:
        logits_parity(cfg, params)
    cache_launches = (cache_parity(cfg, params)
                      if cfg.family in ("dense", "hybrid") else 0)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, cache_launches


def run_api_model(arch: str):
    """Phase 9. One model of ``API_MODELS`` at full width and depth (bf16,
    random weights from seed 0) through ``model_api``: a ``make_batch``
    batch of 4 (seed 13), one prefill and greedy ``decode_step``s, timed on
    the host clock with a synchronize after each call, after one untimed
    prefill. Every kernel's launch count is set to 0 just before the timed
    prefill and read after the last step: K3 once a layer in the VLM's
    prefill, every other kernel 0 (decode runs ``layers.attend``; whisper
    has no kernel route, in the JAX package as here). Logits finite, tokens
    in the vocab, then phase 7's check on the same batch. Returns the
    kernel launches."""
    import time
    from repro_torch import device as devmod
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_api as api

    dev = devmod.resolve(DEV)
    cfg = get_config(arch).replace(use_pallas=True)
    seq, steps = API_MODELS[arch]
    params = api.init_params(cfg, devmod.generator(0, dev), dev)
    batch = api.make_batch(cfg, InputShape("chip_smoke", seq, API_BATCH,
                                           "prefill"), gen(13), device=dev)
    kernels = wrappers()
    with torch.inference_mode():
        api.prefill(cfg, params, batch)                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        logits, cache = api.prefill(cfg, params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        tokens, step_s = [], []
        for _ in range(steps):
            tok = logits[:, -1].argmax(-1)[:, None]
            tokens.append(tok)
            t0 = time.perf_counter()
            logits, cache = api.decode_step(cfg, params, cache,
                                            {"token": tok})
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            finite = finite and bool(torch.isfinite(logits).all())
        launches = {name: fn.launches for name, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
    toks = torch.cat(tokens, dim=1)
    want = per_prefill(cfg)
    say("model_api", arch=cfg.name, layers=cfg.num_layers, batch=API_BATCH,
        seq=int(seq), text_tokens=int(batch["tokens"].shape[1]),
        prefill_ms=prefill_s * 1e3, decode_steps=steps,
        decode_ms_per_step=float(np.median(step_s)) * 1e3,
        decode_ms_per_step_mean=float(np.mean(step_s)) * 1e3,
        decode_tokens_per_s=API_BATCH * steps / sum(step_s),
        max_memory_allocated_bytes=peak,
        first_tokens=toks[:, :8].tolist(), launches=launches,
        launches_per_prefill=want, finite=finite)
    if logits.shape != (API_BATCH, 1, cfg.vocab_size) or not finite:
        raise AssertionError(f"{cfg.name}: logits {tuple(logits.shape)}, "
                             f"finite {finite}")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: a token id is out of the vocab")
    if launches != want:
        raise AssertionError(f"{cfg.name}: kernel launches {launches}; want "
                             f"{want} (one prefill)")
    del cache, logits
    logits_parity(cfg, params, batch)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 10: train
# ---------------------------------------------------------------------------

# qwen3-0.6b at full width and depth, trained at TRAIN_4K's sequence length
# (4096) on a batch cut from its 256 rows to 8 for one card, remat "dots",
# AdamW warming up over 5 of 6 steps. The batch runs as 4 microbatches of 2
# rows: with 2 of 4, the f32 logits' log-sum-exp and its backward (about
# 10 GB each a microbatch of 4 x 4096 x 151,936) took the card past 72 GB
# in use, and the second step ran out of memory
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICROBATCHES = 4096, 8, 4
TRAIN_STEPS, TRAIN_SAVE_AT = 6, 3
TRAIN_OPT = dict(lr=1e-3, warmup_steps=5, total_steps=6)
# the resumed steps' losses against the uninterrupted run's: both run the
# same kernels on the same inputs under deterministic algorithms, so they
# must be bit-equal (limit 0)
TRAIN_RESUME_LIMIT = 0.0
# reduced qwen3-0.6b in f32, one step (batch 2 x 128 tokens) on the card
# against the same step on the CPU. Loss 2e-5 rel: only the order of f32
# sums differs (a TF32 product would move it by ~1e-4). Parameters, as
# tests/test_torch_train_steps.py holds the port against the JAX package:
# every element within 2e-5 rel + 2.1 lr (where a gradient is near eps or
# its sign differs, an AdamW step moves up to 2 lr apart), 99.9% of them
# within 1e-6 rel + 1e-3 lr.
TRAIN_CPU_TOL = dict(loss=2e-5, hard=(2e-5, 2.1), tight=(1e-6, 1e-3),
                     share=0.999)


def _tree_bytes(tree) -> int:
    from repro_torch.models.params import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _trees_equal(a, b) -> bool:
    from repro_torch.models.params import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def train_on_cpu_and_card():
    """One f32 step of reduced qwen3-0.6b on the card and on the CPU, from
    the same parameters and batch; returns the comparison's numbers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import model_api as api
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(TRAIN_ARCH).reduced()
    oc = opt.OptConfig(**TRAIN_OPT)
    params = tree_map(lambda t: t.float(), api.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    raw = TokenStream(DataConfig(cfg.vocab_size, 128, 2,
                                 mean_doc_len=32)).batch(0)
    out = {}
    for dev in ("cpu", DEV):
        p = tree_map(lambda t: t.to(dev), params)
        state = opt.init_state(oc, api.model_specs(cfg), dev)
        new, _, m = make_train_step(cfg, oc)(p, state,
                                             batch_to_device(raw, dev))
        out[dev] = (float(m["loss"]), float(m["lr"]),
                    [t.cpu() for t in tree_leaves(new)])
    (l_cpu, lr, want), (l_card, _, got) = out["cpu"], out[DEV]
    hard_r, hard_lr = TRAIN_CPU_TOL["hard"]
    tight_r, tight_lr = TRAIN_CPU_TOL["tight"]
    worst, close, total = 0.0, 0, 0
    for g, w in zip(got, want):
        err = (g - w).abs()
        worst = max(worst, float((err / (hard_r * w.abs()
                                         + hard_lr * lr)).max()))
        close += int((err <= tight_r * w.abs() + tight_lr * lr).sum())
        total += err.numel()
    res = dict(loss_cpu=l_cpu, loss_card=l_card,
               loss_rel_err=abs(l_card - l_cpu) / abs(l_cpu),
               worst_of_hard_limit=worst, share_within_tight=close / total,
               tolerance=TRAIN_CPU_TOL)
    say("train_cpu", arch=cfg.name, dtype="float32", **res)
    if (res["loss_rel_err"] > TRAIN_CPU_TOL["loss"] or worst > 1.0
            or res["share_within_tight"] < TRAIN_CPU_TOL["share"]):
        raise AssertionError(f"the card's train step differs from the "
                             f"CPU's: {res}")


def train() -> dict:
    """Phase 10: qwen3-0.6b trained at full width through
    ``launch.train.train_loop``, on the plain routes with autograd's
    backward, as the JAX package trains. Steps 1-3, an async checkpoint at
    step 3 restored into fresh tensors on the card and held bit-equal to
    the trained state; steps 4-6 of the uninterrupted run and again from
    the restored state, their losses compared; every kernel's launch count
    set to 0 before training and read after (0: training runs no kernel);
    one step under remat "full" beside "dots" for the peak; a step with
    ``use_pallas`` raises; then reduced qwen3 in f32 on the card against
    the CPU. Returns the launches."""
    import shutil
    import tempfile
    import time
    from repro_torch import device as devmod
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch.train import (batch_to_device, restore_latest,
                                          train_loop)
    from repro_torch.models import model_api as api
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    dev = devmod.resolve(DEV)
    cfg = get_config(TRAIN_ARCH).replace(remat="dots")
    oc = opt.OptConfig(**TRAIN_OPT)
    stream = TokenStream(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                    TRAIN_BATCH))

    def fresh():
        return (api.init_params(cfg, devmod.generator(0, dev), dev),
                opt.init_state(oc, api.model_specs(cfg), dev))

    def log(line):
        print(f"[train] {line}", flush=True)

    kernels = wrappers()
    ckdir = tempfile.mkdtemp(prefix=".train_ckpt_", dir=ROOT)
    # deterministic algorithms (cuBLAS's needs CUBLAS_WORKSPACE_CONFIG,
    # which main sets before the first product), without the fill of each
    # new allocation that the mode adds by default
    torch.use_deterministic_algorithms(True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        params, state = fresh()
        say("train_model", arch=cfg.name, layers=cfg.num_layers,
            seq=TRAIN_SEQ, batch=TRAIN_BATCH,
            microbatches=TRAIN_MICROBATCHES, remat=cfg.remat,
            param_bytes=_tree_bytes(params), opt_state_bytes=_tree_bytes(
                {k: v for k, v in state.items() if k != "step"}))
        ck = Checkpointer(ckdir, retain=2, async_save=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        params, state, first = train_loop(
            cfg, oc, params, state, stream, TRAIN_SAVE_AT,
            microbatches=TRAIN_MICROBATCHES, ck=ck, ckpt_every=TRAIN_SAVE_AT,
            log=log)
        t0 = time.perf_counter()
        r_params, r_state, start = restore_latest(ck, *fresh())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        saved_equal = (start == TRAIN_SAVE_AT
                       and _trees_equal(r_params, params)
                       and _trees_equal(r_state, state))
        del r_params, r_state
        params, state, rest = train_loop(
            cfg, oc, params, state, stream, TRAIN_STEPS,
            start_step=TRAIN_SAVE_AT, microbatches=TRAIN_MICROBATCHES,
            log=log)
        peak = torch.cuda.max_memory_allocated()
        launches = {name: fn.launches for name, fn in kernels.items()}
        whole = first + rest

        # one step under remat "full", for its peak beside "dots"
        batch = batch_to_device(stream.batch(TRAIN_STEPS), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        make_train_step(cfg.replace(remat="full"), oc, TRAIN_MICROBATCHES)(
            params, state, batch)
        torch.cuda.synchronize()
        full_ms = (time.perf_counter() - t0) * 1e3
        full_peak = torch.cuda.max_memory_allocated()

        # the kernel route has no backward: a step raises before launching
        k3 = kernels["flash_attention"].launches
        small = {k: v[:1, :128] for k, v in batch.items()}
        try:
            make_train_step(cfg.replace(use_pallas=True), oc)(params, state,
                                                              small)
            raised = False
        except RuntimeError as e:
            raised = "has no backward" in str(e)
        raised = raised and kernels["flash_attention"].launches == k3
        del params, state, batch
        gc.collect()
        torch.cuda.empty_cache()

        # steps 4-6 again, from the step-3 checkpoint
        params, state, start = restore_latest(ck, *fresh())
        _, _, resumed = train_loop(
            cfg, oc, params, state, stream, TRAIN_STEPS, start_step=start,
            microbatches=TRAIN_MICROBATCHES, log=log)
        del params, state
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        shutil.rmtree(ckdir, ignore_errors=True)

    losses = [r["loss"] for r in whole]
    resume_err = max(abs(a["loss"] - b["loss"])
                     for a, b in zip(resumed, whole[TRAIN_SAVE_AT:]))
    steady = [r["ms"] for r in whole[1:]]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    say("train", arch=cfg.name, steps=whole, resumed=resumed,
        tokens_per_step=tokens,
        tokens_per_s=tokens / (float(np.median(steady)) / 1e3),
        ms_per_step_median=float(np.median(steady)),
        first_step_ms=whole[0]["ms"],
        max_memory_allocated_bytes=peak,
        full_remat_step_ms=full_ms,
        full_remat_max_memory_allocated_bytes=full_peak,
        restore_s=restore_s, restored_bit_equal=saved_equal,
        resumed_max_abs_loss_err=resume_err,
        resume_limit=TRAIN_RESUME_LIMIT, launches=launches,
        use_pallas_step_raises=raised)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    if any(launches.values()):
        raise AssertionError(f"training launched kernels: {launches}")
    if not saved_equal:
        raise AssertionError("the restored step-3 state differs from the "
                             "saved one")
    if resume_err > TRAIN_RESUME_LIMIT:
        raise AssertionError(f"resumed losses differ by {resume_err}")
    if not raised:
        raise AssertionError("a train step with use_pallas did not raise "
                             "before launching")
    if peak > 75e9:
        raise AssertionError(f"training peak {peak} bytes above 75 GB")
    train_on_cpu_and_card()
    return launches


# ---------------------------------------------------------------------------
# Phase 11: a device mesh of one rank on the card
# ---------------------------------------------------------------------------

# The script runs on one card, and NCCL takes one rank a device: the mesh
# is (1, 1) ("data", "model") over a world of one (NCCL, an in-memory
# store). Behaviour that needs more ranks runs on four CPU ranks in
# tests/test_torch_mesh_ranks.py.
MESH_ARCH = "qwen3-0.6b"
MESH_TRAIN_SEQ, MESH_TRAIN_BATCH = 4096, 2
MESH_PROMPTS, MESH_PROMPT_LEN, MESH_DECODE_STEPS = 4, 1024, 32
MESH_MOE = ("mixtral-8x7b", 2, 256)             # arch, batch, sequence
# the prefill runs K3 both ways: its last-token logits within TOL. Decode
# runs two algorithms: the split-K body casts unnormalised probabilities to
# the bf16 cache's dtype, the plain attention normalised ones, so their
# bf16 roundings differ; the JAX package's own test holds its two decode
# routes to 5e-2 (tests/test_perf_variants.py), and so does this phase
MESH_DECODE_TOL = (5e-2, 5e-2)


def mesh_phase() -> dict:
    """Phase 11 (``[mesh]``): the port on a mesh of one rank, each run
    against the same run without a mesh. Returns K3's launches through the
    local-shard wrapper in one prefill."""
    import shutil
    import tempfile
    import time
    import torch.distributed as dist
    from repro_torch import device as devmod
    from repro_torch import sharding as shd
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.mesh_parity import fingerprint, leaf_diffs
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import model_api as api
    from repro_torch.models import params as pm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    dev = devmod.resolve(DEV)
    kernels = wrappers()
    mesh = make_local_mesh(1, device=dev)
    out = {}
    ckdir = tempfile.mkdtemp(prefix=".mesh_ckpt_", dir=ROOT)
    try:
        # --- one train step, ZeRO-placed state, against the meshless step
        cfg = get_config(MESH_ARCH).replace(remat="dots")
        oc = opt.OptConfig(**TRAIN_OPT)
        specs = api.model_specs(cfg)
        p_sh = api.param_shardings(cfg, mesh)
        s_sh = opt.state_shardings(oc, specs, mesh)
        raw = TokenStream(DataConfig(cfg.vocab_size, MESH_TRAIN_SEQ,
                                     MESH_TRAIN_BATCH)).batch(0)
        batch = batch_to_device(raw, dev)
        step = make_train_step(cfg, oc)
        torch.use_deterministic_algorithms(True)
        fill = torch.utils.deterministic.fill_uninitialized_memory
        torch.utils.deterministic.fill_uninitialized_memory = False
        try:
            runs = {}
            for placed in (False, True):
                params = api.init_params(cfg, devmod.generator(0, dev), dev)
                state = opt.init_state(oc, specs, dev)
                b = batch
                if placed:
                    params = pm.distribute(params, p_sh)
                    state = pm.distribute(state, s_sh)
                    b = pm.distribute(batch, api.batch_shardings(
                        cfg, mesh, InputShape("chip_smoke", MESH_TRAIN_SEQ,
                                              MESH_TRAIN_BATCH, "train")))
                ms, first, prints = [], None, []
                with shd.use_mesh(mesh if placed else None):
                    for _ in range(2):     # the second step is timed
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        res = step(params, state, b)
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t0) * 1e3)
                        first = first or res
                        prints.append(fingerprint(pm.tree_map(
                            lambda t: t.to_local() if shd.is_dtensor(t)
                            else t, {"params": res[0], "state": res[1]})))
                runs[placed] = (first, ms, prints)
                del params, state, res
                gc.collect()
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = fill
        (p0, s0, m0), ms0, fp0 = runs[False]
        (p1, s1, m1), ms1, fp1 = runs[True]
        # the card's step takes one of two bit patterns (PERF.md §6):
        # each way must repeat; the mesh's is held to the meshless one's
        # within leaf_diffs' bounds, set from the two patterns' spread
        bit_equal = fp1[0] in fp0
        placed_ok = (all(tuple(t.placements) == sh.placements for t, sh in
                         zip(pm.tree_leaves(p1), pm.tree_leaves(p_sh)))
                     and all(tuple(t.placements) == sh.placements
                             for t, sh in zip(pm.tree_leaves(s1),
                                              pm.tree_leaves(s_sh))))
        loss0, loss1 = float(m0["loss"]), float(m1["loss"].full_tensor())
        gn0, gn1 = (float(m0["grad_norm"]),
                    float(m1["grad_norm"].full_tensor()))
        lr = float(m0["lr"])
        local = {"params": pm.tree_map(lambda t: t.to_local(), p1),
                 "state": pm.tree_map(lambda t: t.to_local(), s1)}
        diffs = leaf_diffs(local, {"params": p0, "state": s0}, lr)
        say("mesh", check="train_step", arch=cfg.name, mesh=[1, 1],
            tokens=MESH_TRAIN_SEQ * MESH_TRAIN_BATCH, loss_meshless=loss0,
            loss_mesh=loss1, grad_norm_meshless=gn0, grad_norm_mesh=gn1,
            bit_equal_to_meshless=bit_equal,
            meshless_steps_repeat=fp0[0] == fp0[1],
            mesh_steps_repeat=fp1[0] == fp1[1],
            placements_as_declared=placed_ok, step_ms_meshless=ms0[1],
            step_ms_mesh=ms1[1], first_step_ms_meshless=ms0[0],
            first_step_ms_mesh=ms1[0],
            against_meshless_first_step={
                k: v for k, v in diffs.items() if k != "differing_leaves"},
            differing_leaves=len(diffs["differing_leaves"]))
        if (not placed_ok or fp0[0] != fp0[1] or fp1[0] != fp1[1]
                or not diffs["ok"]
                or abs(loss1 - loss0) > 2 ** -6 * abs(loss0)
                or abs(gn1 - gn0) > 2 ** -5 * abs(gn0)):
            raise AssertionError("the mesh's train step differs from the "
                                 "meshless one")

        # --- the sharded state through a checkpoint, onto the mesh
        ck = Checkpointer(ckdir, retain=1)
        tree = {"params": p1, "opt": s1}
        t0 = time.perf_counter()
        ck.save(1, tree)
        back = ck.restore(1, tree, shardings={"params": p_sh, "opt": s_sh})
        torch.cuda.synchronize()
        ck_s = time.perf_counter() - t0
        bit_equal = all(
            torch.equal(a.to_local(), b.to_local())
            and tuple(a.placements) == tuple(b.placements)
            for a, b in zip(pm.tree_leaves(tree), pm.tree_leaves(back)))
        say("mesh", check="checkpoint", leaves=len(pm.tree_leaves(tree)),
            restored_bit_equal=bit_equal, save_and_restore_s=ck_s)
        if not bit_equal:
            raise AssertionError("the restored sharded state differs")
        del p0, s0, p1, s1, tree, back, local
        gc.collect()
        torch.cuda.empty_cache()

        # --- prefill through K3's local-shard wrapper, then split-K decode
        cfg = get_config(MESH_ARCH).replace(use_pallas=True,
                                            decode_impl="shmap_flash")
        params = api.init_params(cfg, devmod.generator(0, dev), dev)
        toks = torch.from_numpy(gen(21).integers(
            1, cfg.vocab_size, (MESH_PROMPTS, MESH_PROMPT_LEN))).to(dev)
        runs, forced = {}, None
        with torch.inference_mode():
            for placed in (False, True):
                p = pm.distribute(params, api.param_shardings(cfg, mesh)) \
                    if placed else params
                with shd.use_mesh(mesh if placed else None):
                    for fn in kernels.values():
                        fn.launches = 0
                    logits, cache = api.prefill(cfg, p, {"tokens": toks},
                                                MESH_PROMPT_LEN)
                    k3 = kernels["flash_attention"].launches
                    if placed:
                        cache = pm.distribute(cache, api.cache_shardings(
                            cfg, mesh, MESH_PROMPTS, MESH_PROMPT_LEN))
                    seq, lg, step_ms = [], [], []
                    for t in range(MESH_DECODE_STEPS):
                        full = (logits.full_tensor() if shd.is_dtensor(
                            logits) else logits)
                        lg.append(full[:, -1].float())
                        # the mesh run decodes the meshless run's greedy
                        # tokens, so that the two runs see the same inputs
                        tok = (full[:, -1].argmax(-1)[:, None]
                               if forced is None else forced[:, t:t + 1])
                        seq.append(tok)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        logits, cache = api.decode_step(cfg, p, cache,
                                                        {"token": tok})
                        torch.cuda.synchronize()
                        step_ms.append((time.perf_counter() - t0) * 1e3)
                    runs[placed] = (torch.stack(lg), k3,
                                    float(np.median(step_ms)))
                    forced = torch.cat(seq, 1)
                    del cache, logits
        (l0, k30, ms0), (l1, k31, ms1) = runs[False], runs[True]
        atol, rtol = TOL[torch.bfloat16]
        d_atol, d_rtol = MESH_DECODE_TOL
        pre_err = float((l1[0] - l0[0]).abs().max())
        dec_err = float((l1[1:] - l0[1:]).abs().max())
        # greedy choices: the same wherever the meshless run's top two are
        # further apart than twice the largest logit difference (closer
        # pairs are ties at this precision; random weights make many)
        top2 = l0.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * max(dec_err, pre_err)
        same = l1.argmax(-1) == l0.argmax(-1)
        tokens_ok = bool(same[clear].all())
        ok = (tokens_ok
              and bool(torch.allclose(l1[0], l0[0], atol=atol, rtol=rtol))
              and bool(torch.allclose(l1[1:], l0[1:], atol=d_atol,
                                      rtol=d_rtol)))
        say("mesh", check="prefill_decode", arch=cfg.name,
            prompts=MESH_PROMPTS, prompt_len=MESH_PROMPT_LEN,
            decode_steps=MESH_DECODE_STEPS, k3_launches_mesh=k31,
            k3_launches_meshless=k30, want_k3=cfg.num_layers,
            greedy_tokens_equal=tokens_ok,
            greedy_agreement=float(same.float().mean()),
            clear_choices=int(clear.sum()), choices=int(clear.numel()),
            prefill_logits_max_abs_err=pre_err,
            prefill_tol=dict(atol=atol, rtol=rtol),
            decode_logits_max_abs_err=dec_err,
            decode_tol=dict(atol=d_atol, rtol=d_rtol),
            decode_ms_per_step_meshless=ms0, decode_ms_per_step_mesh=ms1)
        if k31 != cfg.num_layers or k30 != cfg.num_layers or not ok:
            raise AssertionError("the mesh's prefill and decode differ")
        out["flash_attention"] = k31
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # --- mixtral's sorted dispatch on the local shards
        arch, b, s = MESH_MOE
        cfg = get_config(arch).replace(num_layers=MOE_PARITY_LAYERS)
        params = api.init_params(cfg, devmod.generator(0, dev), dev)
        toks = torch.from_numpy(gen(22).integers(
            1, cfg.vocab_size, (b, s))).to(dev)
        from repro_torch.models import transformer as tfm
        res = {}
        with torch.inference_mode():
            for placed in (False, True):
                c = cfg.replace(moe_impl="sorted_shmap" if placed
                                else "sorted")
                p = pm.distribute(params, api.param_shardings(c, mesh)) \
                    if placed else params
                with shd.use_mesh(mesh if placed else None):
                    h, _, aux = tfm.forward_hidden(
                        c, p, tfm.embed_inputs(c, p, {"tokens": toks}))
                res[placed] = tuple(t.full_tensor() if shd.is_dtensor(t)
                                    else t for t in (h, aux))
        (h0, a0), (h1, a1) = res[False], res[True]
        same = bool(torch.equal(h0, h1)) and bool(torch.equal(a0, a1))
        say("mesh", check="moe_sorted_shmap", arch=cfg.name,
            layers=cfg.num_layers, batch=b, seq=s, outputs_equal=same,
            max_abs_err=float((h1.float() - h0.float()).abs().max()),
            aux=[float(a0), float(a1)])
        if not same:
            raise AssertionError("sorted_shmap on the mesh differs from "
                                 "sorted without one")
        del params, res, h0, h1
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# Phase 12: the dry-run on a fake world (a process of its own)
# ---------------------------------------------------------------------------

DRYRUN_ARGS = ("--arch", "qwen3-0.6b", "--arch", "mixtral-8x7b", "--mesh",
               "both")
DRYRUN_CELLS = 14          # (3 + 4 applicable shapes) x 2 meshes
DRYRUN_TIMEOUT_S = 600     # 174-187 s beside [mesh] on the card machine


def _dryrun_cores():
    """(the dry-run's cores, this process's): the last core of this
    process's set with its hyperthread siblings, and every other core."""
    cpus = set(os.sched_getaffinity(0))
    last = max(cpus)
    own = {last}
    try:
        with open(f"/sys/devices/system/cpu/cpu{last}/topology/"
                  "thread_siblings_list") as f:
            for part in f.read().strip().split(","):
                lo, _, hi = part.partition("-")
                own.update(range(int(lo), int(hi or lo) + 1))
    except OSError:
        pass
    own &= cpus
    return own, (cpus - own) or cpus


def _pin_threads(cpus) -> None:
    """Every thread of this process onto ``cpus``."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:
            pass


def start_dryrun(cores):
    """Phase 12 (``[dryrun]``) starts after phase 10: ``python -m
    repro_torch.launch.dryrun`` in a subprocess of its own (its fake world
    of 256 / 512 ranks cannot share a process with a real process group),
    on ``cores`` while the card runs phase 11."""
    import tempfile
    import time
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    d = tempfile.mkdtemp(dir=ROOT, prefix=".dryrun_")
    log = open(os.path.join(d, "log.txt"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS,
         "--out", os.path.join(d, "dryrun.json")],
        stdout=log, stderr=subprocess.STDOUT, text=True, env=env,
        preexec_fn=lambda: os.sched_setaffinity(0, cores))
    return proc, d, log, time.perf_counter()


def dryrun_phase(handle) -> dict:
    """Phase 12: wait for the dry-run; every cell must be OK. Prints each
    cell's per-device argument bytes, FLOPs, collective bytes and
    seconds."""
    import shutil
    import time
    proc, d, log, t0 = handle
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
        wall = time.perf_counter() - t0
        log.close()
        out = os.path.join(d, "dryrun.json")
        cells = json.load(open(out)) if os.path.exists(out) else []
        tail = open(os.path.join(d, "log.txt")).read()[-4000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(d, ignore_errors=True)
    for c in cells:
        say("dryrun", arch=c["arch"], shape=c["shape"], mesh=c["mesh"],
            ok=c["ok"], argument_bytes_per_dev=(c["mem"] or {}).get(
                "argument_bytes"), flops_per_dev=c["flops_per_dev"],
            coll_bytes_per_dev=c["coll_bytes_per_dev"], lower_s=c["lower_s"])
    say("dryrun", cells=len(cells), ok=sum(c["ok"] for c in cells),
        wall_s=wall, returncode=rc)
    if rc != 0 or len(cells) != DRYRUN_CELLS or not all(c["ok"]
                                                        for c in cells):
        raise AssertionError("dry-run failed:\n" + tail)
    return {"cells": len(cells), "wall_s": wall}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # read by cuBLAS when its first handle is made; phase 10 runs under
    # deterministic algorithms, which ask for it. 8 x 4 MiB is PyTorch's
    # default workspace on sm_90 already.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    card = card_name_and_power()
    print(card, flush=True)
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)

    from decode_attention_cases import SERVING
    dryrun, cpus = None, os.sched_getaffinity(0)
    try:
        build_kernels()
        err_fa = check_flash()
        err_ssd = check_ssd()
        err_rg = check_rglru()
        err_ps = check_policy_score()
        err_da, k4_kernels = check_decode()
        check_forecast()
        t_fa, t_ssd, t_rg = time_flash(), time_ssd(), time_rglru()
        t_da = time_decode()
        t_ps = time_policy_score()
        t_dec, t_cross = time_decision()
        time_forecast()
        policy_parity()
        launches = {"admission": admission_stream()}
        inspector_launches = inspector()
        serve_fdn_launches = examples()
        cache_launches = 0
        for arch in MODELS:
            launches[arch], n = run_model(arch)
            cache_launches += n
        for arch in API_MODELS:
            launches[arch] = run_api_model(arch)
        train()
        # the dry-run's host work beside phase 11 only, on its own cores
        own, rest = _dryrun_cores()
        _pin_threads(rest)
        dryrun = start_dryrun(own)
        mesh_launches = mesh_phase()
        dryrun_phase(dryrun)
    finally:
        if dryrun is not None and dryrun[0].poll() is None:
            dryrun[0].kill()
        _pin_threads(cpus)

    def entry(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    print(json.dumps({"kernels": [
        # K3 at qwen3's S=1024; the same at S=4096 beside it, and
        # mixtral-8x7b's launches (24 layers) and errors at its buckets
        dict(entry("flash_attention", "flash_attention",
                   "src/repro/kernels/flash_attention.py:80",
                   launches["qwen3-0.6b"]["flash_attention"], err_fa["d128"],
                   t_fa["d128"]),
             graph_device_ms=t_fa["d128"]["graph_device_ms"],
             s4096=t_fa["d128_4096"],
             mixtral=dict(
                 launches=launches["mixtral-8x7b"]["flash_attention"],
                 max_abs_err=err_fa["mixtral"]),
             # one prefill on the mesh of one rank, through the wrapper
             mesh=dict(launches=mesh_launches["flash_attention"])),
        dict(entry("flash_attention_d256", "flash_attention",
                   "src/repro/kernels/flash_attention.py:80",
                   launches["recurrentgemma-9b"]["flash_attention"],
                   err_fa["d256"], t_fa["d256"]),
             graph_device_ms=t_fa["d256"]["graph_device_ms"]),
        # phi-3-vision's prefill, B=4, S=1024, head_dim 96
        dict(entry("flash_attention_d96", "flash_attention",
                   "src/repro/kernels/flash_attention.py:80",
                   launches["phi-3-vision-4.2b"]["flash_attention"],
                   err_fa["d96"], t_fa["d96"]),
             graph_device_ms=t_fa["d96"]["graph_device_ms"],
             shape=list(PHI3_PREFILL)),
        # at S=1024; the serving buckets 256/512/768 beside it. "launches"
        # counts wrapper calls; each bf16 call runs kernels_per_call kernels
        dict(entry("ssd_scan", "ssd_scan", "src/repro/kernels/ssd_scan.py:75",
                   launches["mamba2-2.7b"]["ssd_scan"], err_ssd, t_ssd[1024]),
             graph_device_ms=t_ssd[1024]["graph_device_ms"],
             kernels_per_call=len(t_ssd[1024]["kernels_per_call"]),
             buckets={s: dict(ms=t_ssd[s]["ms"],
                              graph_device_ms=t_ssd[s]["graph_device_ms"],
                              bound_ms=t_ssd[s]["bound_ms"],
                              plain_ms=t_ssd[s]["plain_ms"])
                      for s in (256, 512, 768)}),
        # at S=1024; the serving buckets 256/512/768 beside it
        dict(entry("rglru_scan", "rglru_scan",
                   "src/repro/kernels/rglru_scan.py:48",
                   launches["recurrentgemma-9b"]["rglru_scan"], err_rg,
                   t_rg[1024]),
             graph_device_ms=t_rg[1024]["graph_device_ms"],
             kernels_per_call=len(t_rg[1024]["kernels_per_call"]),
             buckets={s: dict(ms=t_rg[s]["ms"],
                              graph_device_ms=t_rg[s]["graph_device_ms"],
                              bound_ms=t_rg[s]["bound_ms"],
                              plain_ms=t_rg[s]["plain_ms"])
                      for s in (256, 512, 768)}),
        # at the admission stream's decision shape, F=1 x P=5; the whole
        # decision's host ms (K1 on its staging block) at F=5 and by F
        dict(entry("fused_composite_decide", "policy_score",
                   "src/repro/kernels/policy_score.py:351",
                   launches["admission"]["fused_composite_decide"], err_ps,
                   t_ps[("fused_composite_decide", 1, 5)]),
             host_ms_per_decision=t_dec, decision_by_functions=t_cross,
             inspector_launches=inspector_launches,
             serve_fdn_launches=serve_fdn_launches),
        # no path of either package reaches K2: its launches are 0
        entry("composite_decide", "policy_score",
              "src/repro/kernels/policy_score.py:266",
              launches["admission"]["composite_decide"], err_ps,
              t_ps[("composite_decide", 1, 5)]),
        # no serving or admission path reaches K4 (decode runs
        # layers.attend): 0 launches there; its own path is the cache phase.
        # Times at qwen3-0.6b's cache, recurrentgemma-9b's beside them
        dict(entry("decode_attention", "decode_attention",
                   "src/repro/kernels/decode_attention.py:62",
                   sum(run["decode_attention"] for run in launches.values()),
                   err_da, t_da["d128"]),
             attend_ms=t_da["d128"]["attend_ms"],
             graph_device_ms=t_da["d128"]["graph_device_ms"],
             kernels_per_call=len(k4_kernels["d128"]),
             cache_phase_launches=cache_launches,
             shape=list(SERVING["d128"]),
             d256=dict(t_da["d256"], shape=list(SERVING["d256"]),
                       kernels_per_call=len(k4_kernels["d256"]))),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
