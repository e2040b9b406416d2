"""Training launcher of the port, twin of the JAX package's
``launch/train.py``, on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch qwen3-0.6b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --steps 20 \
        --ckpt-dir /tmp/ck --ckpt-every 5            # on the card

Includes the fault-tolerance loop: a checkpoint every ``--ckpt-every`` steps
(written asynchronously), and on (re)start the latest step restored and
training resumed after it.

As in the reference, ``--reduced`` is a flag whose default is already True,
so the launcher always trains ``cfg.reduced()`` (ROADMAP.md, Queue 3, lists
this fault of the reference); ``train_loop`` trains any config, and
``chip_smoke.py`` drives it at full width. Parameters are random bf16 drawn
from a seeded generator; steps run the plain routes (``use_pallas`` off),
whose backward is autograd's.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.models import model_api as api
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """A ``TokenStream`` batch on ``device``: token ids as int64 (the index
    dtype of torch), every other array in its own dtype."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(device)
    return out


def restore_latest(ck: Checkpointer, params, state
                   ) -> Tuple[Dict, Dict, int]:
    """The latest checkpoint's params and optimizer state, restored onto
    the devices of ``params`` and ``state``, and its step; or the inputs
    and step 0 when the directory holds none."""
    latest = ck.latest_step()
    if latest is None:
        return params, state, 0
    restored = ck.restore(latest, {"params": params, "opt": state})
    return restored["params"], restored["opt"], latest


def train_loop(cfg: ModelConfig, oc: opt.OptConfig, params, state,
               stream: TokenStream, steps: int, *, start_step: int = 0,
               microbatches: int = 1, ck: Optional[Checkpointer] = None,
               ckpt_every: int = 10,
               log: Callable[[str], None] = functools.partial(print,
                                                              flush=True)
               ) -> Tuple[Dict, Dict, List[Dict]]:
    """Train from step ``start_step`` to ``steps`` on ``stream``'s batches
    (batch i at step i, so a resumed run sees the batches the interrupted
    one would have), saving ``{"params", "opt"}`` to ``ck`` after every
    ``ckpt_every``-th step. Returns (params, state, one record a step:
    step, loss, lr, grad_norm, ms). A step's ms is host time up to the
    end of its work on the device."""
    dev = state["step"].device
    step_fn = make_train_step(cfg, oc, microbatches)
    history = []
    for i in range(start_step, steps):
        batch = batch_to_device(stream.batch(i), dev)
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"step": i + 1, "loss": float(m["loss"]), "lr": float(m["lr"]),
               "grad_norm": float(m["grad_norm"]), "ms": ms}
        history.append(rec)
        log(f"step {i:4d} loss={rec['loss']:.4f} lr={rec['lr']:.2e} "
            f"gnorm={rec['grad_norm']:.3f} ({ms:.1f} ms)")
        if ck and (i + 1) % ckpt_every == 0:
            ck.save(i + 1, {"params": params, "opt": state},
                    extra={"arch": cfg.name})
    if ck:
        ck.wait()
    return params, state, history


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    try:
        dev = devmod.resolve(args.device)
    except devmod.NoCudaDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    oc = opt.OptConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps,
                       compress_grads=args.compress_grads)
    params = api.init_params(cfg, devmod.generator(0, dev), dev)
    state = opt.init_state(oc, api.model_specs(cfg), dev)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    stream = TokenStream(dc)

    start_step = 0
    ck = None
    if args.ckpt_dir:
        ck = Checkpointer(args.ckpt_dir, retain=3, async_save=True)
        params, state, start_step = restore_latest(ck, params, state)
        if start_step:
            print(f"restored checkpoint step {start_step}")

    t0 = time.time()
    train_loop(cfg, oc, params, state, stream, args.steps,
               start_step=start_step, microbatches=args.microbatches, ck=ck,
               ckpt_every=args.ckpt_every)
    tokens = args.steps * args.batch * args.seq
    dt = time.time() - t0
    print(f"done: {tokens} tokens in {dt:.1f}s "
          f"({tokens / max(dt, 1e-9):.0f} tok/s) on {dev}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
