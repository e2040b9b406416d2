"""Serving launcher: continuous-batching engine over an architecture of the
port, on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --requests 16 --batch-size 4                  # reduced width, card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --full  # full width
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b

The dense (qwen3, yi, llama3), MoE (mixtral-8x7b, dbrx-132b), SSM
(mamba2-2.7b) and hybrid (recurrentgemma-9b) families are served. The
engine feeds token ids only, as the JAX engine does, so the VLM
(phi-3-vision) and encoder-decoder (whisper-small) archs, whose prefill
also reads image embeddings or audio frames, exit with status 2 and a
message; they run through ``models.model_api.prefill``/``decode_step``
(``chip_smoke.py`` drives them so). Like the JAX launcher it serves
``cfg.reduced()`` unless ``--full`` is given. Prefill takes the port's
kernel route (``cfg.use_pallas``: flash attention, the SSD scan, the RG-LRU
scan): the CUDA kernels on the card, their plain PyTorch versions on the
CPU. Weights are random, drawn from ``--seed`` with an explicit generator.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.configs.base import ENCDEC, VLM
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models import model_api as api
from repro_torch.serving.engine import Request, ServingEngine


def make_requests(vocab_size: int, n: int, max_new_tokens: int, seed: int,
                  prompt_len=(4, 48)) -> List[Request]:
    """``n`` requests with numpy-seeded prompt lengths in
    [prompt_len[0], prompt_len[1]) and random token ids."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(1, vocab_size,
                                        int(rng.integers(*prompt_len))
                                        ).astype(np.int32),
                    max_new_tokens=max_new_tokens)
            for i in range(n)]


WORKLOAD_NEW_TOKENS = 32


def workload(cfg, params, n_requests: int, seed: int = 0):
    """The serving workload that chip_smoke.py and launch/trace_serve.py
    measure: a fresh engine (batch 4, context 1024) and ``n_requests``
    requests of 64-1000 prompt tokens and 32 new tokens each."""
    eng = ServingEngine(cfg, params, batch_size=4, max_context=1024)
    reqs = make_requests(cfg.vocab_size, n_requests, WORKLOAD_NEW_TOKENS,
                         seed, prompt_len=(64, 1001))
    return eng, reqs


def run_timed(eng: ServingEngine, reqs: List[Request]) -> float:
    """Serve ``reqs`` to the end on the card; returns the wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-context", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="serve the full-width config, not cfg.reduced()")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.family in (VLM, ENCDEC):
        print(f"error: {args.arch} ({cfg.family}) reads "
              f"{'image embeddings' if cfg.family == VLM else 'audio frames'}"
              f" beside its tokens, and the serving engine feeds token ids "
              f"only, as the JAX package's does; drive it through "
              f"repro_torch.models.model_api.prefill and decode_step",
              file=sys.stderr)
        return 2
    try:
        dev = devmod.resolve(args.device)
    except devmod.NoCudaDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg = cfg if args.full else cfg.reduced()
    cfg = cfg.replace(use_pallas=True)
    params = api.init_params(cfg, devmod.generator(args.seed, dev), dev)
    eng = ServingEngine(cfg, params, batch_size=args.batch_size,
                        max_context=args.max_context)
    reqs = make_requests(cfg.vocab_size, args.requests, args.max_new_tokens,
                         args.seed)
    t0 = time.perf_counter()
    eng.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    lat = [r.done_s - r.submitted_s for r in reqs]
    ttft = [r.first_token_s - r.submitted_s for r in reqs]
    print(f"served {len(reqs)} requests of {cfg.name} on {dev} in {dt:.2f}s")
    print(f"  p50/p90 latency: {np.percentile(lat, 50):.3f}/"
          f"{np.percentile(lat, 90):.3f}s")
    print(f"  p50 TTFT: {np.percentile(ttft, 50):.3f}s")
    print(f"  engine: {eng.stats()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
