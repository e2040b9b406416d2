"""Quickstart: train a small model for a few steps, then serve it with the
continuous-batching engine. Twin of the JAX package's
``examples/quickstart.py``, on the CUDA card unless ``--device cpu`` is
given.

    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from repro_torch import device as devmod
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.launch.train import batch_to_device
from repro_torch.models import model_api as api
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = devmod.resolve(args.device)
    except devmod.NoCudaDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    # ---- 1. pick an architecture (any of the 10 assigned ids works) ----
    cfg = get_config("qwen3-0.6b").reduced()
    print(f"arch={cfg.name} params={api.param_count(cfg):,}")

    # ---- 2. train a few steps on the synthetic pipeline ----
    oc = opt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=30)
    params = api.init_params(cfg, devmod.generator(0, dev), dev)
    state = opt.init_state(oc, api.model_specs(cfg), dev)
    step = make_train_step(cfg, oc)
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=8, mean_doc_len=16))
    for i in range(30):
        params, state, m = step(params, state,
                                batch_to_device(stream.batch(i), dev))
        if i % 10 == 0:
            print(f"  step {i:3d} loss={float(m['loss']):.3f}")

    # ---- 3. serve it: continuous batching over a shared KV cache ----
    eng = ServingEngine(cfg, params, batch_size=3, max_context=96)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        int(rng.integers(4, 40))
                                        ).astype(np.int32),
                    max_new_tokens=8) for i in range(6)]
    eng.run(reqs)
    print("served:", [len(r.out_tokens) for r in reqs], eng.stats())
    return 0


if __name__ == "__main__":
    sys.exit(main())
