"""Multi-pod training walkthrough, twin of the JAX package's
``examples/train_multipod.py``: the pieces a pod launcher uses (mesh,
sharding rules) shown on the local mesh, then a real reduced-scale training
run with checkpoint and restart, its parameters and AdamW state placed on
that mesh as DTensors.

    PYTHONPATH=src python -m repro_torch.launch.train_multipod [--device cpu]

The local mesh is (world // 1, 1) named ("data", "model") over the ranks
that exist: run alone, a world of one on ``--device`` (NCCL on the card,
the default; gloo on the CPU), which the script starts and ends. Without a
card and without ``--device cpu`` it exits 2 naming the missing card.

For every architecture x shape on the 256- and 512-rank production meshes:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import torch.distributed as dist

from repro_torch import device as devmod
from repro_torch import sharding as shd
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import batch_to_device
from repro_torch.models import model_api as api
from repro_torch.models import params as pm
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = devmod.resolve(args.device)
    except devmod.NoCudaDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    started = not dist.is_initialized()
    try:
        mesh = make_local_mesh(device=dev)
        run(mesh, dev)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return 0


def run(mesh, dev) -> None:
    cfg = get_config("qwen3-1.7b")
    print(f"== {cfg.name}: what the pod launcher assembles ==")
    n = api.param_count(cfg)
    print(f"  parameters: {n:,} ({2 * n / 1e9:.1f} GB bf16)")
    print(f"  sharding rules (examples), on the local mesh "
          f"{shd.mesh_shape(mesh)}:")
    specs = api.param_pspecs(cfg, mesh)
    placed = api.param_shardings(cfg, mesh)
    for k in ("embed", "final_norm"):
        print(f"    {k:12s} -> {specs[k]}  {placed[k].placements}")
    lay, lp = specs["layers"], placed["layers"]
    print(f"    attn.wq      -> {lay['attn']['wq']}  "
          f"{lp['attn']['wq'].placements}")
    print(f"    mlp.wi       -> {lay['mlp']['wi']}  "
          f"{lp['mlp']['wi'].placements}")
    print("  (on the 16x16 / 2x16x16 production meshes these resolve to "
          "DP x TP placements; see repro_torch/launch/dryrun.py)")

    # ---- real fault-tolerant training at reduced scale ----
    print("\n== reduced-scale training with checkpoint/restart ==")
    rcfg = cfg.reduced()
    oc = opt.OptConfig(lr=2e-3, warmup_steps=3, total_steps=16)
    mspecs = api.model_specs(rcfg)
    p_sh = api.param_shardings(rcfg, mesh)
    s_sh = opt.state_shardings(oc, mspecs, mesh)
    params = pm.distribute(
        api.init_params(rcfg, devmod.generator(0, dev), dev), p_sh)
    state = pm.distribute(opt.init_state(oc, mspecs, dev), s_sh)
    step = make_train_step(rcfg, oc)
    stream = TokenStream(DataConfig(vocab_size=rcfg.vocab_size, seq_len=32,
                                    global_batch=4))

    def train(params, state, steps):
        with shd.use_mesh(mesh):
            for i in steps:
                batch = pm.distribute(batch_to_device(stream.batch(i), dev),
                                      {k: shd.named_sharding(
                                          mesh, v.shape, ("batch", None))
                                       for k, v in stream.batch(i).items()})
                params, state, m = step(params, state, batch)
        return params, state, m

    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, retain=2)
        params, state, m = train(params, state, range(8))
        ck.save(8, {"params": params, "opt": state})
        print(f"  step 8 loss={float(m['loss'].full_tensor()):.3f}; "
              f"checkpoint saved")

        # --- simulate a node failure: restart from the checkpoint, placed
        # on the mesh by the rules ---
        restored = ck.restore(8, {"params": params, "opt": state},
                              shardings={"params": p_sh, "opt": s_sh})
        params, state, m = train(restored["params"], restored["opt"],
                                 range(8, 16))
        print(f"  restarted and trained to step 16: "
              f"loss={float(m['loss'].full_tensor()):.3f}")


if __name__ == "__main__":
    sys.exit(main())
