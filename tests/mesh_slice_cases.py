"""Which slice of a tensor each device holds, by the port's placements and by
the JAX package's ``NamedSharding``, on the same 8-device meshes: run as
``python tests/mesh_slice_cases.py port|jax`` in a fresh process (the JAX
side needs 8 host devices, the port's side a fake world of 8 ranks), which
prints one JSON object: {mesh: [[case, coordinate, slices], ...]}.

A device at mesh coordinate c is rank c flattened row-major on the port's
side and ``mesh.devices[c]`` on the JAX side. The port's side also places
the 2x2x2 cases on the (4, 2) ("data", "model") mesh that fuses "pod" and
"data" pod-major, as ``make_production_mesh(multi_pod=True)`` builds the
2x16x16 mesh ("2x2x2-fused", rank r at coordinate (r // 4, r // 2 % 2,
r % 2) of the 3-d mesh)."""
import itertools
import json
import os
import sys

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# (shape, logical axes): batches, a vocab-sharded table, a cache sharded on
# the sequence, a ZeRO-sharded optimizer leaf, replicated fallbacks
CASES = [((16, 8), ("batch", None)),
         ((64, 16), ("vocab", "embed")),
         ((2, 8, 16, 2, 4), ("layers", "batch", "kv_seq", None, None)),
         ((4, 16, 24), ("layers", "zero", "mlp")),
         ((6, 16), ("heads", "batch")),
         ((3, 5), ("batch", "mlp")),
         ((8, 8, 8), ("experts", "batch", "expert_mlp"))]


def _slices(index, shape):
    return [[s.start or 0, s.stop if s.stop is not None else n]
            for s, n in zip(index, shape)]


def port():
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_mesh

    out = {}
    meshes = dict(MESHES, **{"2x2x2-fused": ((4, 2), ("data", "model"))})
    for name, (shape, axes) in meshes.items():
        n = 1
        for s in shape:
            n *= s
        rows = []
        for rank in range(n):
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=n)
            mesh = make_mesh(shape, axes)
            coord = list(mesh.get_coordinate())
            if name.endswith("fused"):
                coord = [rank // 4, rank // 2 % 2, rank % 2]
            for i, (dims, names) in enumerate(CASES):
                full = torch.arange(int(torch.tensor(dims).prod())).reshape(
                    dims)
                local = shd.distribute(
                    full, shd.named_sharding(mesh, dims, names)).to_local()
                # the local block's first element and shape give its slice
                first = int(local.flatten()[0])
                start = list(torch.unravel_index(torch.tensor(first), dims))
                rows.append([i, coord, [[int(a), int(a) + b] for a, b in
                                        zip(start, local.shape)]])
            dist.destroy_process_group()
        out[name] = rows
    return out


def jax_side():
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from jax.sharding import NamedSharding

    from repro import sharding as shd
    from repro.launch.mesh import make_mesh
    from repro.train import optimizer  # noqa: F401  registers "zero"

    out = {}
    for name, (shape, axes) in MESHES.items():
        mesh = make_mesh(shape, axes)
        rows = []
        for coord in itertools.product(*(range(s) for s in shape)):
            dev = mesh.devices[coord]
            for i, (dims, names) in enumerate(CASES):
                sh = NamedSharding(mesh, shd.spec_for(mesh, dims, names))
                rows.append([i, list(coord),
                             _slices(sh.devices_indices_map(dims)[dev],
                                     dims)])
        out[name] = rows
    return out


if __name__ == "__main__":
    print(json.dumps(port() if sys.argv[1] == "port" else jax_side()))
