"""Device meshes for the production pod slices and for the local ranks,
ported from the JAX package's ``launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions over the process group that is initialised. The functions here
build meshes; they do not start a world, except ``make_local_mesh``, which
starts a world of one where none exists. Importing this module touches no
process-group state.

- ``make_production_mesh`` is the 16x16 single-pod ("data", "model") or the
  2x16x16 multi-pod mesh, over a world of 256 or 512 ranks (the dry-run's
  fake process group). The reference's multi-pod mesh has the axes ("pod",
  "data", "model"), and every rule shards "pod" and "data" together,
  pod-major (``sharding.dp_axes``: the batch and the ZeRO axis): the port
  builds it as (32, 16) ("data", "model"), its "data" dim the two fused.
  Each rank holds the same slice. DTensor plans a redistribution over a
  tensor dim sharded on two mesh dims by a search over placements (four
  minutes for mamba2-2.7b's train cell at depth 1, 12 s fused);
- ``make_mesh(shape, axes)`` any shape over the world;
- ``make_local_mesh(model_parallel)`` (world // model_parallel,
  model_parallel) named ("data", "model") over the ranks that exist.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve


def _device_type() -> str:
    """The mesh's device type, from the world's backend: NCCL ranks hold
    cards, every other backend (gloo, the fake group) the CPU."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks, its
    "pod" and "data" axes fused pod-major into one "data" dim of 32)."""
    shape = (32, 16) if multi_pod else (16, 16)
    return make_mesh(shape, ("data", "model"))



def init_world_of_one(device: DeviceLike = None) -> None:
    """A process group of one rank, in memory (a ``HashStore``: no network
    and no port): NCCL on the card, gloo on the CPU. On the card the rank
    uses the current CUDA device."""
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_local_mesh(model_parallel: Optional[int] = None,
                    device: DeviceLike = None):
    """Mesh over the ranks that exist; where no process group is
    initialised, over a world of one on ``device`` (the card unless the
    caller asks for the CPU)."""
    if not dist.is_initialized():
        init_world_of_one(device)
    n = dist.get_world_size()
    mp = model_parallel or 1
    return make_mesh((n // mp, mp), ("data", "model"))
