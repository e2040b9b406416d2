"""Multi-pod dry-run: run every (architecture x input-shape) cell once on
the 16x16 single-pod mesh AND the 2x16x16 multi-pod mesh, as one rank of a
fake world of 256 or 512 ranks, ported from the JAX package's
``launch/dryrun.py`` (``dryrun_lib`` says what is counted and how).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun             # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out results/dryrun.json

It needs no card: the fake world's ranks hold no data (``FakeTensorMode``),
so the host does the work, as the reference's host placeholder devices do.
The 2x16x16 mesh is built with its "pod" and "data" axes fused pod-major
(``launch/mesh.make_production_mesh``): each rank holds the reference's
slice.
The fake world cannot share a process with a real process group: the
script initialises it itself, for each mesh, and tears it down after.
Exit code 1 when any cell fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch.distributed as dist

from repro_torch.configs.base import ALL_SHAPES, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config, get_shape
from repro_torch.launch.dryrun_lib import lower_cell
from repro_torch.launch.mesh import make_production_mesh


def init_fake_world(world_size: int) -> None:
    """This process as rank 0 of a fake world of ``world_size`` ranks
    (PyTorch's private testing backend: collectives return at once)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    choices=ARCH_IDS, help="architecture id(s); default all")
    ap.add_argument("--shape", action="append", default=None,
                    choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None,
                    help="cut every arch to this many layers (dryrun_lib."
                         "with_depth); default: full depth")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    archs = args.arch or ARCH_IDS
    shapes = ([get_shape(s) for s in args.shape] if args.shape
              else list(ALL_SHAPES))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    from repro_torch.launch.dryrun_lib import with_depth

    results, failures = [], []
    for multi in meshes:
        init_fake_world(512 if multi else 256)
        try:
            mesh = make_production_mesh(multi_pod=multi)
            for arch in archs:
                cfg = get_config(arch)
                if args.depth is not None:
                    cfg = with_depth(cfg, args.depth)
                for shape in shapes:
                    ok, reason = shape_applicable(cfg, shape)
                    if not ok:
                        print(f"SKIP {arch} x {shape.name}: {reason}")
                        continue
                    res = lower_cell(cfg, shape, mesh, args.microbatches,
                                     "2x16x16" if multi else "16x16")
                    tag = "OK  " if res.ok else "FAIL"
                    print(f"{tag} {arch:22s} {shape.name:12s} "
                          f"mesh={res.mesh:10s} lower={res.lower_s:6.1f}s "
                          f"compile={res.compile_s:6.1f}s "
                          f"flops/dev={res.flops_per_dev:.3e} "
                          f"coll/dev={res.coll_bytes_per_dev:.3e}",
                          flush=True)
                    if res.ok and args.verbose and res.mem:
                        print("     mem/dev: " + json.dumps(res.mem))
                    if not res.ok:
                        print("     " + res.error)
                        failures.append(res)
                    results.append(res.to_json())
        finally:
            dist.destroy_process_group()

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {len(results)} cells -> {args.out}")
    print(f"{len(results) - len(failures)}/{len(results)} cells OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
