"""Logical-axis sharding rules -> DTensor placements, ported from the JAX
package's ``sharding.py``.

Every parameter and activation in the model zoo is annotated with *logical*
axis names ("vocab", "mlp", "heads", ...). This module maps logical names to
mesh axes with divisibility-checked fallback (replicate when a dim does not
divide), so the same model code runs without a mesh, on a world of one, on
the CPU ranks of the tests and on the 16x16 / 2x16x16 production meshes of
the dry-run.

DP  = "batch"   -> ("pod", "data") when the mesh has a pod axis, else ("data",)
TP  = width-ish -> "model" (heads / flattened q-kv dims / mlp / vocab / lru /
                   ssm inner dim)
EP  = "experts" -> "model" when the expert count divides it (dbrx), else the
                   per-expert ffn dim takes "model" (mixtral)
SP  = "kv_seq"  -> "model" for long decode caches (flash-decode style split-K)
ZeRO-1: optimizer states additionally shard a replicated dim over the data
        axes ("zero"; see train/optimizer.py).

Where the JAX package hands a ``PartitionSpec`` to XLA's partitioner, the
port hands DTensor its placements:

- ``spec_for`` gives the same per-dimension tuple of mesh-axis names as the
  reference's ``PartitionSpec`` (trailing ``None``s dropped);
- ``placements`` turns it into one ``Shard(d)`` / ``Replicate()`` per mesh
  dimension; a tensor dim on a tuple of axes (``("pod", "data")``) is
  sharded over both, major axis first, as JAX lays it out;
- ``constrain`` is ``DTensor.redistribute`` to the rule's placements (the
  identity with no mesh installed or on a plain tensor);
- ``shard_map`` is ``local_map`` over those placements, with ``psum`` /
  ``pmax`` / ``axis_index`` over a mesh axis for the body (a mean over
  the data axes is a ``Partial`` sum of each shard's share);
- ``local_shards`` runs a function that treats the batch and heads
  independently (attention, the scans, the kernels) on each rank's shards.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``, or an ``AbstractMesh`` (names and sizes only: enough for
``spec_for``, no process group needed).
"""
from __future__ import annotations

import contextvars
import sys
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

# Ordered candidates per logical axis name. "batch" is special-cased.
# "zero" is the ZeRO-1 / FSDP axis; only ``params.fsdp_spec`` produces it.
RULES = {
    "batch":     ("__dp__",),
    "vocab":     ("model",),
    "mlp":       ("model",),
    "heads":     ("model",),     # flattened n_heads*head_dim output dim
    "kv":        ("model",),     # flattened n_kv_heads*head_dim output dim
    "experts":   ("model",),
    "expert_mlp": ("model",),    # per-expert ffn dim (used when EP impossible)
    "lru":       ("model",),     # RG-LRU width
    "ssm_inner": ("model",),     # mamba d_inner / heads*headdim
    "ssm_state": (),
    "kv_seq":    ("model",),     # sequence-sharded decode caches
    "embed":     (),
    "seq":       (),
    "seq_sp":    ("model",),     # Megatron-style sequence parallelism
    "layers":    (),
    "frames":    (),
    "zero":      ("__dp__",),    # ZeRO-1 optimizer state / FSDP params
    None:        (),
}


class AbstractMesh(NamedTuple):
    """Axis names and sizes of a mesh, without devices (as JAX's
    ``AbstractMesh``): what ``spec_for`` needs."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size}, for a DeviceMesh or an AbstractMesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _mesh_size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= shape[a]
    return n


def spec_for(mesh, dims: Sequence[Optional[int]],
             axes: Sequence[Optional[str]]) -> Tuple:
    """The spec of a tensor of `dims` annotated with logical `axes`: one
    entry per dim, a mesh axis name, a tuple of them, or None.

    A mesh axis is assigned at most once per tensor; a logical axis falls back
    to replication when its dim does not divide the mesh axis size.
    `dims[i]` may be None to skip the divisibility check. Trailing Nones are
    dropped, as ``PartitionSpec`` drops them.
    """
    assert len(dims) == len(axes), (dims, axes)
    names = axis_names(mesh)
    used = set()
    out = []
    for dim, name in zip(dims, axes):
        assigned = None
        for cand in RULES.get(name, ()):
            mesh_ax = dp_axes(mesh) if cand == "__dp__" else cand
            if not mesh_ax:
                continue
            flat = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
            if any(a not in names or a in used for a in flat):
                continue
            if dim is not None and dim % _mesh_size(mesh, flat) != 0:
                continue
            # one axis is named alone, as PartitionSpec normalizes it
            assigned = flat[0] if len(flat) == 1 else flat
            used.update(flat)
            break
        out.append(assigned)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(mesh, spec: Sequence) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension,
    ``Shard(d)`` where tensor dim d names it, else ``Replicate()``. A mesh
    dimension of size 1 is ``Replicate()`` whatever the spec (the same
    layout): DTensor of PyTorch 2.11 refuses to flatten a sharded dim even
    over one rank."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = mesh_shape(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        flat = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in flat]
        if idx != sorted(idx):
            # DTensor shards a dim over several mesh dims in mesh order
            raise ValueError(f"axes {flat} are not in the mesh's order "
                             f"{names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """Where a tensor lives: the mesh, the spec and its placements."""
    mesh: object
    spec: Tuple
    placements: Tuple


def named_sharding(mesh, dims, axes) -> NamedSharding:
    spec = spec_for(mesh, dims, axes)
    return NamedSharding(mesh, spec, placements(mesh, spec))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor. Until something has imported
    ``torch.distributed.tensor`` nothing is one, so the paths without a mesh
    never pay for that import (about a second)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (the same full tensor on every rank) placed by ``sharding``.
    Each rank keeps its own slice; nothing is sent (``src_data_rank=None``),
    so the ranks must hold the same values, as after a seeded init."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)


# --------------------------------------------------------------------------
# Activation-constraint context. Model code calls constrain(x, ...axes) and
# the launcher installs the mesh; with no mesh installed constrain() is the
# identity.
# --------------------------------------------------------------------------
_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


class use_mesh:
    """Context manager installing the mesh used by constrain(). Under a
    device mesh a plain tensor that meets a DTensor is taken as replicated
    (as a constant is in the reference's jitted code)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._token = None
        self._implicit = None

    def __enter__(self):
        self._token = _MESH.set(self.mesh)
        if self.mesh is not None and not isinstance(self.mesh, AbstractMesh):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            self._implicit = implicit_replication()
            self._implicit.__enter__()
        return self.mesh

    def __exit__(self, *exc):
        if self._implicit is not None:
            self._implicit.__exit__(*exc)
            self._implicit = None
        _MESH.reset(self._token)
        return False


def current_mesh():
    return _MESH.get()


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``x`` redistributed to the placements of its logical ``axes`` (the
    identity without a mesh, or on a plain tensor)."""
    mesh = _MESH.get()
    if mesh is None or not is_dtensor(x):
        return x
    want = placements(mesh, spec_for(mesh, x.shape, axes))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


# --------------------------------------------------------------------------
# shard_map: a body over each rank's local shards
# --------------------------------------------------------------------------


def shard_map(f, mesh, in_specs, out_specs, in_grad_specs=None):
    """``f`` run on each rank's local shards, as JAX's ``shard_map``: the
    inputs are redistributed to ``in_specs`` (None for a non-tensor
    argument), ``f`` sees plain local tensors, and its outputs are taken as
    laid out by ``out_specs`` (a list for several outputs). A spec may also
    be a tuple of placements: an output a later redistribution reduces (a
    ``Partial`` sum over an axis). ``in_grad_specs`` say where the
    gradients of the inputs lie (default: as the inputs), for a body whose
    ranks use different parts of a replicated input."""
    from torch.distributed.tensor.experimental import local_map

    def place(spec):
        if spec is None:
            return None
        if spec and not isinstance(spec[0], (str, tuple, type(None))):
            return tuple(spec)                 # placements already
        return placements(mesh, spec)

    outs = (tuple(place(s) for s in out_specs)
            if isinstance(out_specs, list) else place(out_specs))
    kw = {}
    if in_grad_specs is not None:
        kw["in_grad_placements"] = tuple(place(s) for s in in_grad_specs)
    return local_map(f, out_placements=outs,
                     in_placements=tuple(place(s) for s in in_specs),
                     device_mesh=mesh, redistribute_inputs=True, **kw)


def _group(axis: str):
    mesh = _MESH.get()
    return (mesh, axis_names(mesh).index(axis))


def _reduce(x: torch.Tensor, op: str, axes) -> torch.Tensor:
    import torch.distributed._functional_collectives as fc
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        x = fc.wait_tensor(fc.all_reduce(x, op, _group(a)))
    return x


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum of ``x`` over the ranks of the mesh axis (or axes) ``axes``, in a
    ``shard_map`` body under ``use_mesh``. No backward."""
    return _reduce(x, "sum", axes)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    return _reduce(x, "max", axes)


def axis_index(axis: str) -> int:
    """This rank's coordinate on the mesh axis ``axis``."""
    return _MESH.get().get_local_rank(axis)


def settle(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its pending cross-rank reductions done (every ``Partial``
    placement made ``Replicate``); the identity on a plain tensor. DTensor
    loses track of a pending masked sum (the vocab-sharded gather's) when a
    view drops the dim it was taken on, so such a sum is settled first."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def _mesh_dims_sharding(x, dim: int):
    """The mesh dimensions over which DTensor ``x`` shards tensor dim
    ``dim``."""
    return [i for i, p in enumerate(x.placements)
            if p.is_shard() and p.dim % x.ndim == dim % x.ndim]


def _replicate_on(x, mesh_dims):
    from torch.distributed.tensor import Replicate
    if not mesh_dims:
        return x
    want = [Replicate() if i in mesh_dims else p
            for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, want)


def split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n*d) -> (..., n, d). On a DTensor whose last dim is sharded,
    the shard moves to the head dim where ``n`` divides the mesh dims that
    shard it; otherwise ``x`` is first replicated over them (DTensor cannot
    unflatten a dim into heads that do not divide; XLA reshards silently).
    Both give the same values."""
    if is_dtensor(x):
        dims = _mesh_dims_sharding(x, -1)
        size = 1
        for i in dims:
            size *= x.device_mesh.size(i)
        if n % size:
            x = _replicate_on(x, dims)
    return x.reshape(*x.shape[:-1], n, d)


def match_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q (B,S,H,D), k/v (B,T,KH,D) for attention on DTensors: q's heads
    are replicated over any mesh dim that shards them but not k's heads (each
    rank then holds every query head of the kv heads it holds). Plain
    tensors come back as they are."""
    if not is_dtensor(q):
        return q, k, v
    qd = _mesh_dims_sharding(q, 2)
    kd = _mesh_dims_sharding(k, 2) if is_dtensor(k) else []
    return _replicate_on(q, [i for i in qd if i not in kd]), k, v


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, n, d) -> (B, S, n*d), placed by the "heads" rule (the input of
    the attention's output projection). The redistribution's backward then
    hands the gradient back whole over "model" wherever the n heads could
    not take a shard, so the reshape's backward never splits an unevenly
    sharded dim into heads. Identity in value; plain tensors are only
    reshaped."""
    flat = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return constrain(flat, "batch", None, "heads")


def take_rows(x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Rows [start, stop) of ``x``'s dim 0. Of a DTensor, the whole
    tensor's rows (gathered over the mesh dims that shard dim 0), placed
    again as ``x`` is where the rows divide those dims and replicated
    there otherwise (the rules' fallback)."""
    if not is_dtensor(x):
        return x[start:stop]
    from torch.distributed.tensor import Replicate
    dims = _mesh_dims_sharding(x, 0)
    rows = _replicate_on(x, dims)[start:stop]
    size = 1
    for i in dims:
        size *= x.device_mesh.size(i)
    want = tuple(x.placements) if (stop - start) % size == 0 else tuple(
        Replicate() if i in dims else p for i, p in enumerate(x.placements))
    if tuple(rows.placements) == want:
        return rows
    return rows.redistribute(x.device_mesh, want)


class _ContiguousGrad(torch.autograd.Function):
    """Identity forward; backward hands on the gradient made contiguous
    (a local shard's gradient may come as a strided view, which a ``view``
    in a backward, the body's or DTensor's, cannot take: without it the
    backward on the (2, 2) and (1, 4) CPU meshes fails)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grad(t: torch.Tensor) -> torch.Tensor:
    return _ContiguousGrad.apply(t) if t.requires_grad else t


class ShardedDimError(ValueError):
    """``local_shards`` was given a placement that shards a dim the
    function does not treat independently."""


def _shards(t) -> Dict[int, int]:
    """{mesh dim: tensor dim} of a DTensor's ``Shard`` placements."""
    return {i: p.dim % t.ndim for i, p in enumerate(t.placements)
            if p.is_shard()}


def _unshardable(args, roles) -> Optional[str]:
    """Why ``local_shards`` cannot take ``args`` with these ``roles`` (a
    pending sum, or a sharded dim the function does not treat
    independently: role None), or None."""
    for t, role in zip(args, roles):
        if not is_dtensor(t):
            continue
        if any(p.is_partial() for p in t.placements):
            return "an input has a pending sum"
        for i, d in _shards(t).items():
            if role[d] is None:
                return (f"dim {d} of an input of shape {tuple(t.shape)} is "
                        f"sharded over mesh dim {i}; only the batch and "
                        f"heads may be")
    return None


def local_shardable(args, roles) -> bool:
    """Whether ``local_shards`` takes ``args`` with these ``roles``."""
    return _unshardable(args, roles) is None


def local_shards(name: str, fn, args, roles, outs):
    """``fn`` on each rank's local shards of ``args`` (DTensors, or plain
    tensors taken as replicated), its outputs DTensors again: a
    ``shard_map`` whose placements follow the first argument's.

    ``roles[i]`` names what each dim of ``args[i]`` is: "b" (batch) and
    "h" (heads / columns) may be sharded; "g" (kv heads, SSD groups) may be
    sharded as the first argument's "h" or not at all (then each rank
    narrows it to the groups its heads use); None must not be sharded, and
    raises ``ShardedDimError`` (``local_shardable`` tells beforehand).
    ``args[0]`` sets the batch and head placements, and the other arguments
    are redistributed to them. ``outs[j]`` maps the dims of ``args[0]`` to
    the dims of output j.

    Autograd runs through it: an argument that ends replicated over a mesh
    dim on which ``args[0]`` is sharded is read by every rank there, so its
    gradient is a ``Partial`` sum over that dim."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    nd = mesh.ndim
    args = [t if is_dtensor(t) else DTensor.from_local(
        t, mesh, [Replicate()] * nd, run_check=False) for t in args]
    why = _unshardable(args, roles)
    if why is not None:
        raise ShardedDimError(f"{name} on local shards: {why}")
    # the first argument's placement of its batch and heads, by mesh dim
    first = _shards(args[0])
    want = {i: roles[0][d] for i, d in first.items()}
    coord = mesh.get_coordinate()
    h_parts, h_index = 1, 0
    for i in range(nd):
        if want.get(i) == "h":
            h_parts *= mesh.size(i)
            h_index = h_index * mesh.size(i) + coord[i]
    n_heads = args[0].shape[roles[0].index("h")]

    in_pl, grad_pl, narrows = [args[0].placements], [args[0].placements], [
        None]
    for t, role in zip(args[1:], roles[1:]):
        pl, narrow, have = [], None, _shards(t)
        for i in range(nd):
            r = want.get(i)
            if r is not None and r in role:
                pl.append(Shard(role.index(r)))
            elif r == "h" and "g" in role and have.get(i) == role.index("g"):
                pl.append(Shard(role.index("g")))
            else:
                pl.append(Replicate())
                if r == "h" and "g" in role:
                    narrow = role.index("g")
        in_pl.append(tuple(pl))
        grad_pl.append(tuple(Partial() if i in first and p.is_replicate()
                             else p for i, p in enumerate(pl)))
        if narrow is not None:
            per = n_heads // t.shape[narrow]        # heads of one group
            h_loc = n_heads // h_parts
            if (h_loc % per if h_loc >= per else per % h_loc):
                raise ShardedDimError(
                    f"{name}: {h_loc} local heads of {n_heads} do not map "
                    f"onto whole groups of {per}")
            off = h_index * h_loc
            g0, g1 = off // per, (off + h_loc - 1) // per + 1
            narrow = (narrow, g0, g1 - g0)
        narrows.append(narrow)

    def body(*locals_):
        locals_ = [t if n is None else t.narrow(*n)
                   for t, n in zip(locals_, narrows)]
        result = fn(*[_contiguous_grad(t) for t in locals_])
        if isinstance(result, tuple):
            return tuple(_contiguous_grad(r) for r in result)
        return _contiguous_grad(result)

    out_pl = [tuple(Shard(dmap[first[i]]) if i in first else Replicate()
                    for i in range(nd)) for dmap in outs]
    return shard_map(body, mesh, in_pl, out_pl, in_grad_specs=grad_pl)(
        *args)


class _SettleGrad(torch.autograd.Function):
    """Identity forward; backward settles the gradient's pending sums."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return settle(g)


def settle_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, whose gradient reaches the ops before it with its
    pending sums done (``Partial`` made ``Replicate``). DTensor cannot turn a
    ``Partial`` gradient into the masked partial that a vocab-parallel
    lookup's backward needs; a replicated one it can. The identity on a
    plain tensor."""
    return _SettleGrad.apply(x) if is_dtensor(x) else x
