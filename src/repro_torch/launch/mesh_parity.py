"""One train step on a mesh of one rank against the same step without a
mesh, leaf by leaf: the comparison chip_smoke.py's ``[mesh]`` phase makes
(``leaf_diffs`` is its check), with variants that leave out parts of the
mesh path to show what moves the bits, and what the check reads on two
wrong gradients.

    PYTHONPATH=src python -m repro_torch.launch.mesh_parity \\
        [--device cpu] [--arch qwen3-0.6b] [--seq 4096] [--batch 2] \\
        [--reduced]

Every step runs under deterministic algorithms from the same seed-0
parameters and zero AdamW state. One JSON line for each variant, against
the meshless step of the stream's first batch, each naming the earlier
steps it equals bit for bit (``bit_equal_to``):

- ``meshless_again``: the meshless step once more (the step repeats);
- ``mesh``: on the (1, 1) mesh, as chip_smoke.py runs it;
- ``mesh_no_contiguous_grad``: ``sharding.local_shards`` hands gradients on
  as autograd makes them (``sharding._contiguous_grad`` the identity);
- ``mesh_no_local_shards``: attention runs on the DTensors
  (``layers.attend`` never takes ``local_shards``);
- ``wrong_other_batch``: the meshless step of the stream's next batch;
- ``wrong_first_row``: the meshless step of the batch's first row alone.

A variant that raises prints its error. ``--empty-cache`` releases the
caching allocator's blocks before each step. Without a card and without
``--device cpu`` it exits 2 naming the missing card.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from typing import Tuple

import torch

from repro_torch import device as devmod
from repro_torch import sharding as shd

# The parameter bounds are tests/train_cases.py's ``check_params`` for bf16:
# every element within one bf16 ulp + 2.1 lr (hard), 98% within one ulp +
# 0.05 lr (tight).
PARAM_HARD_LR, PARAM_TIGHT_LR, PARAM_TIGHT_SHARE = 2.1, 0.05, 0.98
# The AdamW state, element by element: |got - want| against |want| + the
# leaf's root mean square (the floor keeps entries near zero, where a sum
# in another order moves the most, from reading as large relative errors).
# STATE_HARD holds every element, STATE_TIGHT a share STATE_TIGHT_SHARE of
# them. Set from qwen3-0.6b's step on the H100 (PERF.md §6): the
# meshless step's own two bit patterns read 7.0 at worst and 99.79% of m
# within 2**-7; a wrong gradient (the next batch, or the first row alone)
# reads 99-236 at worst and 27-34% within 2**-7.
STATE_HARD, STATE_TIGHT, STATE_TIGHT_SHARE = 2.0 ** 4, 2.0 ** -7, 0.99
_SHARE_AT = (2.0 ** -12, 2.0 ** -10, 2.0 ** -8, 2.0 ** -7, 2.0 ** -6,
             2.0 ** -4, 2.0 ** -3, 2.0 ** -1)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value (8 significant bits)."""
    a = x.abs().double()
    e = torch.floor(torch.log2(torch.where(a > 0, a, 2.0 ** -126)))
    return 2.0 ** (torch.clamp(e, min=-126) - 7)


def leaf_diffs(got, want, lr: float) -> dict:
    """``got`` against ``want``, trees {"params": ..., "state": {"m", "v",
    "step"}} of plain tensors: the leaves bit-equal and those that differ;
    the worst parameter error over its hard bound and the share within the
    tight one; for m and v, the worst element over ``STATE_HARD``, the share
    within ``STATE_TIGHT`` and the shares within each of ``_SHARE_AT`` (of
    |got - want| / (|want| + the leaf's rms)), and the worst error as a
    share of its leaf's largest entry. ``ok``: every bound holds."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_paths
    keys, gl = _flatten_with_paths(got)
    _, wl = _flatten_with_paths(want)
    equal, differ, worst_p, close, total = 0, [], 0.0, 0, 0
    worst, count = {"m": 0.0, "v": 0.0}, {"m": 0, "v": 0}
    of_max = {"m": 0.0, "v": 0.0}
    within = {"m": [0] * len(_SHARE_AT), "v": [0] * len(_SHARE_AT)}
    for k, g, w in zip(keys, gl, wl):
        same = torch.equal(g, w)
        equal += same
        if not same:
            differ.append(k)
        if not k.startswith("params") and g.numel() == 1:
            continue                                    # the step count
        g, w = g.double(), w.double()
        err = (g - w).abs()
        if k.startswith("params"):
            ulp = _bf16_ulp(w)
            worst_p = max(worst_p, float(
                (err / (ulp + PARAM_HARD_LR * lr)).max()))
            close += int((err <= ulp + PARAM_TIGHT_LR * lr).sum())
            total += err.numel()
        else:
            part = "v" if "/v/" in k else "m"
            ratio = err / (w.abs() + w.square().mean().sqrt()).clamp(
                min=1e-30)
            worst[part] = max(worst[part], float(ratio.max()))
            of_max[part] = max(of_max[part], float(err.max()) / max(
                float(w.abs().max()), 1e-30))
            count[part] += ratio.numel()
            within[part] = [a + int((ratio <= t).sum())
                            for a, t in zip(within[part], _SHARE_AT)]
    out = {"leaves_bit_equal": equal, "leaves": len(keys),
           "differing_leaves": differ,
           "params_worst_of_hard_bound": worst_p,
           "params_share_within_tight": close / max(total, 1)}
    ok = worst_p <= 1.0 and close >= PARAM_TIGHT_SHARE * total
    for part in ("m", "v"):
        n = max(count[part], 1)
        shares = {f"2**{int(math.log2(t))}": a / n
                  for t, a in zip(_SHARE_AT, within[part])}
        tight = shares[f"2**{int(math.log2(STATE_TIGHT))}"]
        out[f"{part}_worst_of_hard_bound"] = worst[part] / STATE_HARD
        out[f"{part}_share_within_tight"] = tight
        out[f"{part}_shares"] = shares
        out[f"{part}_worst_of_leaf_max"] = of_max[part]
        ok = ok and worst[part] <= STATE_HARD and tight >= STATE_TIGHT_SHARE
    out["ok"] = ok
    return out


def _local(tree):
    from repro_torch.models import params as pm
    return pm.tree_map(lambda t: t.to_local() if shd.is_dtensor(t) else t,
                       tree)


def train_step_once(cfg, oc, params, state, batch, mesh=None) -> dict:
    """One step of ``make_train_step(cfg, oc)``; on ``mesh``, the
    parameters, state and batch placed by the rules first. Returns plain
    tensors: {"params", "state", "loss", "grad_norm", "lr", "ms"}."""
    from repro_torch.configs.base import InputShape
    from repro_torch.models import model_api as api
    from repro_torch.models import params as pm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    if mesh is not None:
        rows, seq = batch["tokens"].shape
        params = pm.distribute(params, api.param_shardings(cfg, mesh))
        state = pm.distribute(state, opt.state_shardings(
            oc, api.model_specs(cfg), mesh))
        batch = pm.distribute(batch, api.batch_shardings(
            cfg, mesh, InputShape("mesh_parity", seq, rows, "train")))
    sync = (torch.cuda.synchronize if batch["tokens"].device.type == "cuda"
            else (lambda: None))
    with shd.use_mesh(mesh):
        sync()
        t0 = time.perf_counter()
        p, s, m = make_train_step(cfg, oc)(params, state, batch)
        sync()
    ms = (time.perf_counter() - t0) * 1e3
    m = {k: float(shd.settle(v).to_local() if shd.is_dtensor(v) else v)
         for k, v in m.items()}
    return {"params": _local(p), "state": _local(s), "loss": m["loss"],
            "grad_norm": m["grad_norm"], "lr": m["lr"], "ms": ms}


def fingerprint(tree) -> Tuple[int, ...]:
    """Two sums over each leaf's bit patterns (plain and weighted by
    position), on the leaf's device: equal trees give equal fingerprints,
    and unequal ones almost surely differ."""
    from repro_torch.models import params as pm
    out = []
    for t in pm.tree_leaves(tree):
        bits = t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                    4: torch.int32, 8: torch.int64}[
                                        t.element_size()]).long().flatten()
        pos = torch.arange(1, bits.numel() + 1, device=bits.device)
        out += [int(bits.sum()), int((bits * pos).sum())]
    return tuple(out)


VARIANTS = ("meshless_again", "mesh", "mesh_no_contiguous_grad",
            "mesh_no_local_shards", "wrong_other_batch", "wrong_first_row")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated, repeats allowed")
    ap.add_argument("--empty-cache", action="store_true",
                    help="release the allocator's cached blocks before "
                    "each step")
    args = ap.parse_args(argv)
    try:
        dev = devmod.resolve(args.device)
    except devmod.NoCudaDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # read by cuBLAS when its first handle is made (deterministic products)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import layers
    from repro_torch.models import model_api as api
    from repro_torch.train import optimizer as opt

    cfg = get_config(args.arch)
    cfg = (cfg.reduced() if args.reduced else cfg).replace(remat="dots")
    oc = opt.OptConfig(lr=1e-3, warmup_steps=5, total_steps=6)
    stream = TokenStream(DataConfig(cfg.vocab_size, args.seq, args.batch))
    batches = [batch_to_device(stream.batch(i), dev) for i in (0, 1)]
    params = api.init_params(cfg, devmod.generator(0, dev), dev)
    state = opt.init_state(oc, api.model_specs(cfg), dev)
    started = not dist.is_initialized()
    mesh = make_local_mesh(1, device=dev)
    torch.use_deterministic_algorithms(True)
    seen = []                          # (run, fingerprint) of each step

    def before():
        if dev.type != "cuda":
            return None
        if args.empty_cache:
            gc.collect()
            torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev)

    try:
        reserved = before()
        ref = train_step_once(cfg, oc, params, state, batches[0])
        want = {"params": ref["params"], "state": ref["state"]}
        seen.append(("0:meshless", fingerprint(want)))
        print(json.dumps({"variant": "meshless", "arch": cfg.name,
                          "tokens": args.seq * args.batch,
                          "loss": ref["loss"], "grad_norm": ref["grad_norm"],
                          "ms": ref["ms"], "reserved_bytes": reserved}),
              flush=True)
        for run, name in enumerate(args.variants.split(","), 1):
            patch = {"mesh_no_contiguous_grad": (shd, "_contiguous_grad",
                                                 lambda t: t),
                     "mesh_no_local_shards": (layers, "local_shardable",
                                              lambda *a: False)}.get(name)
            if patch:
                mod, attr, fn = patch
                orig = getattr(mod, attr)
                setattr(mod, attr, fn)
            b = batches[1] if name == "wrong_other_batch" else batches[0]
            if name == "wrong_first_row":
                b = {k: v[:1] for k, v in b.items()}
            try:
                reserved = before()
                res = train_step_once(cfg, oc, params, state, b,
                                      mesh if name.startswith("mesh")
                                      else None)
                got = {"params": res["params"], "state": res["state"]}
                fp = fingerprint(got)
                line = {"loss": res["loss"], "grad_norm": res["grad_norm"],
                        "ms": res["ms"], "reserved_bytes": reserved,
                        "bit_equal_to": [r for r, f in seen if f == fp],
                        **leaf_diffs(got, want, ref["lr"])}
                seen.append((f"{run}:{name}", fp))
                del res, got
            except Exception as e:                  # noqa: BLE001
                line = {"error": f"{type(e).__name__}: {e}"[:2000]}
            finally:
                if patch:
                    setattr(mod, attr, orig)
            print(json.dumps({"variant": name, **line}), flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
