"""Dry-run library: run every (arch x shape x mesh) cell once on a fake
process group and read what each device would hold, compute and send,
ported from the JAX package's ``launch/dryrun_lib.py``.

The reference lowers and compiles each cell for 512 host placeholder devices
and reads XLA's cost and memory analysis and the collectives of the
partitioned HLO. The port has no compiler in that place. It runs the cell's
step once, eagerly, as one rank of a fake world (``torch.testing.
_internal.distributed.fake_pg``, a PRIVATE testing module of PyTorch: its
collectives send nothing and return at once) under ``FakeTensorMode`` (no
storage is allocated), with the parameters, optimizer state, cache and
batch placed as DTensors by the sharding rules. A dispatch mode under DTensor
sees each rank's local operations and collectives:

- ``flops_per_dev``: the local operations' FLOPs, by the formulas of
  ``torch.utils.flop_counter`` (products, attention, convolutions);
- ``coll_bytes_per_dev`` / ``coll_detail``: the local input bytes of every
  collective, by the reference's kinds (all-reduce, all-gather,
  reduce-scatter, all-to-all, collective-permute);
- ``mem["argument_bytes"]`` / ``mem["output_bytes"]``: the exact sum of the
  local shards' bytes of the step's arguments and outputs. No temporary
  memory is measured, so there is no ``temp_bytes``;
- ``lower_s``: the wall seconds of that run; ``compile_s`` is 0 (nothing is
  compiled).

The reference's ``collective_stats`` and ``_shape_bytes`` parse XLA's HLO
text and have no counterpart here. Importing this module touches no
process-group state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from repro_torch import sharding as shd
from repro_torch.configs.base import ENCDEC, HYBRID, InputShape, ModelConfig
from repro_torch.models import model_api as api
from repro_torch.models import params as pm
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts


# ---------------------------------------------------------------------------
# Depth control
# ---------------------------------------------------------------------------


def with_depth(cfg: ModelConfig, d: int) -> ModelConfig:
    if cfg.family == HYBRID:
        pat = len(cfg.block_pattern)
        tail = cfg.num_layers % pat
        return cfg.replace(num_layers=pat * d + tail)
    if cfg.family == ENCDEC:
        return cfg.replace(num_layers=d, n_enc_layers=d)
    return cfg.replace(num_layers=d)


def full_depth_units(cfg: ModelConfig) -> int:
    if cfg.family == HYBRID:
        return cfg.num_layers // len(cfg.block_pattern)
    return cfg.num_layers


# ---------------------------------------------------------------------------
# Counting a rank's local work
# ---------------------------------------------------------------------------

COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")

_COLL_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


# depth of DTensor's shape inference in progress: it runs each operation
# once on global-shaped stand-ins, which is not work a rank does
_INFERRING = [0]


class _NoCountDuringShapeInference:
    """For the run, DTensor's tensor-meta propagation (PyTorch 2.13 runs
    each operation on global-shaped fake tensors there) is marked, so that
    ``LocalCounter`` does not count it. A PyTorch without the method is
    left alone."""

    def __enter__(self):
        from torch.distributed.tensor import _sharding_prop as sp
        cls = sp.ShardingPropagator
        self._cls = cls
        self._orig = cls.__dict__.get("_propagate_tensor_meta_non_cached")
        if self._orig is None:
            return self
        orig = self._orig

        def marked(*args, **kwargs):
            _INFERRING[0] += 1
            try:
                return orig(*args, **kwargs)
            finally:
                _INFERRING[0] -= 1

        cls._propagate_tensor_meta_non_cached = marked
        return self

    def __exit__(self, *exc):
        if self._orig is not None:
            self._cls._propagate_tensor_meta_non_cached = self._orig
        return False


def _on_meta(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.device.type == "meta"
               for a in args)


class LocalCounter:
    """A dispatch mode under DTensor: it lets DTensor turn each operation
    into local operations and collectives, then counts those, so the numbers
    are one rank's (shape inference on meta or global-shaped stand-ins is
    not counted). Built lazily (importing the module imports no mode)."""

    def __new__(cls):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        from torch.distributed.tensor import DTensor

        class _Counter(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.flops = 0
                self.coll_bytes = {k: 0 for k in COLL_KINDS}
                self.coll_counts = {k: 0 for k in COLL_KINDS}

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented      # let DTensor desugar it
                out = func(*args, **kwargs)
                if _INFERRING[0] or _on_meta(args):
                    return out
                packet = func.overloadpacket
                if packet in flop_registry:
                    self.flops += flop_registry[packet](*args, **kwargs,
                                                        out_val=out)
                kind = _COLL_OPS.get(packet.__name__)
                if kind is not None:
                    self.coll_bytes[kind] += _tensor_bytes(args[0])
                    self.coll_counts[kind] += 1
                return out

        return _Counter()


# ---------------------------------------------------------------------------
# Cell running
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    kind: str
    ok: bool
    error: str = ""
    lower_s: float = 0.0
    compile_s: float = 0.0
    flops_per_dev: float = 0.0
    bytes_per_dev: float = 0.0
    coll_bytes_per_dev: float = 0.0
    coll_detail: Optional[Dict] = None
    mem: Optional[Dict] = None
    n_devices: int = 0
    microbatches: int = 1

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in shd.mesh_shape(mesh).values())


def _n_devices(mesh) -> int:
    n = 1
    for s in shd.mesh_shape(mesh).values():
        n *= s
    return n


def build_cell(cfg: ModelConfig, shape: InputShape, mesh,
               microbatches: Optional[int] = None):
    """Returns (fn, args, in_shardings, out_shardings, donate, n_micro):
    ``args`` are meta tensors, the shardings where each leaf lives."""
    n_chips = _n_devices(mesh)
    oc = opt.OptConfig()
    mspecs = api.model_specs(cfg)
    params_abs = api.abstract_params(cfg)
    params_sh = api.param_shardings(cfg, mesh)

    if shape.kind == "train":
        n_micro = (microbatches if microbatches is not None
                   else ts.default_microbatches(cfg, shape, n_chips))
        step = ts.make_train_step(cfg, oc, n_micro)
        ostate_abs = opt.init_state(oc, mspecs, device="meta")
        ostate_sh = opt.state_shardings(oc, mspecs, mesh)
        batch_abs = api.input_specs(cfg, shape)
        batch_sh = api.batch_shardings(cfg, mesh, shape)
        scalar = shd.named_sharding(mesh, (), ())
        out_sh = (params_sh, ostate_sh,
                  {"loss": scalar, "lr": scalar, "grad_norm": scalar})
        return (step, (params_abs, ostate_abs, batch_abs),
                (params_sh, ostate_sh, batch_sh), out_sh, (0, 1), n_micro)

    if shape.kind == "prefill":
        step = ts.make_prefill_step(cfg, shape.seq_len)
        batch_abs = api.input_specs(cfg, shape)
        batch_sh = api.batch_shardings(cfg, mesh, shape)
        cache_sh = api.cache_shardings(cfg, mesh, shape.global_batch,
                                       shape.seq_len)
        logit_sh = shd.named_sharding(
            mesh, (shape.global_batch, 1, cfg.vocab_size),
            ("batch", None, "vocab"))
        return (step, (params_abs, batch_abs), (params_sh, batch_sh),
                (logit_sh, cache_sh), (), 1)

    # decode
    step = ts.make_serve_step(cfg)
    cache_abs = api.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    cache_sh = api.cache_shardings(cfg, mesh, shape.global_batch,
                                   shape.seq_len)
    batch_abs = api.input_specs(cfg, shape)
    batch_sh = api.batch_shardings(cfg, mesh, shape)
    logit_sh = shd.named_sharding(
        mesh, (shape.global_batch, 1, cfg.vocab_size),
        ("batch", None, "vocab"))
    return (step, (params_abs, cache_abs, batch_abs),
            (params_sh, cache_sh, batch_sh), (logit_sh, cache_sh), (1,), 1)


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (nested dicts
    and tuples)."""
    if isinstance(tree, (tuple, list)):
        return sum(_local_bytes(t) for t in tree)
    return sum(t.to_local().numel() * t.element_size()
               if shd.is_dtensor(t) else t.numel() * t.element_size()
               for t in pm.tree_leaves(tree) if torch.is_tensor(t))


def _place(tree, shardings):
    """Fake tensors of ``tree``'s meta leaves, placed by ``shardings``."""
    def leaf(t, sh):
        return shd.distribute(torch.zeros(t.shape, dtype=t.dtype), sh)
    return pm.tree_map(leaf, tree, shardings)


def _place_out(out, shardings):
    """The step's outputs redistributed to ``shardings`` (the reference's
    ``out_shardings``); a leaf with no sharding stays as it is."""
    if isinstance(out, tuple):
        return tuple(_place_out(o, s) for o, s in zip(out, shardings))
    if isinstance(out, dict):
        return {k: _place_out(v, shardings[k]) if k in shardings else v
                for k, v in out.items()}
    if not torch.is_tensor(out):
        return out
    return shd.distribute(out, shardings)


class _FastStridedShard:
    """DTensor (PyTorch 2.13) marks a dim merged from dims sharded over
    different mesh dims as a strided shard, and sizes and splits it piece
    by piece: one ``chunk`` per (split, rank) pair, tens of thousands at a
    32k sequence, minutes per cell under ``FakeTensorMode``; and it sizes a
    shard with small tensor ops that fake mode would make unreadable. For
    the run, where the dim divides evenly, the shard's size and first
    offset are computed and the shards taken as views ((split, ranks, rest)
    -> rank i), which is what DTensor's own code gives; other cases go to
    DTensor's code, fake mode lifted for the sizing. A PyTorch without
    these methods (2.11 makes no strided shards) is left alone.

    DTensor also plans every redistribution that involves a strided shard
    by a search over placements, seconds a plan: that is most of the time
    of the slow cells on the 2x16x16 mesh, and is left as it is (a greedy
    plan was tried and gave wrong local shapes on some cells)."""

    def __enter__(self):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import placement_types as pt
        self._saved = {}
        cls = getattr(pt, "_StridedShard", None)
        if cls is None:
            return self
        size_fn = getattr(cls, "local_shard_size_and_offset", None)
        split_fn = getattr(cls, "_split_tensor", None)

        def factor(pl) -> int:
            return int(pl.split_factor)

        def sizes(pl, curr, n, rank, offset_mode=0, *rest, **kw):
            # offset modes: 0 the first offset, 1 all of them, 2 none
            sf = factor(pl)
            mode = int(offset_mode)
            if (not rest and not kw and mode in (0, 2)
                    and all(isinstance(v, int) for v in (curr, n, rank))
                    and curr % (sf * n) == 0):
                return curr // n, (None if mode == 2
                                   else rank * (curr // (sf * n)))
            with unset_fake_temporarily():
                return size_fn(pl, curr, n, rank, offset_mode, *rest, **kw)

        def split(pl, tensor, n, *rest, with_padding=True, contiguous=True,
                  **kw):
            sf, d = factor(pl), pl.dim
            size = tensor.shape[d]
            if rest or kw or not isinstance(size, int) or size % (sf * n):
                return split_fn(pl, tensor, n, *rest,
                                with_padding=with_padding,
                                contiguous=contiguous, **kw)
            view = tensor.unflatten(d, (sf, n, size // (sf * n)))
            shards = [view.select(d + 1, i).flatten(d, d + 1)
                      for i in range(n)]
            if contiguous:
                shards = [t.contiguous() for t in shards]
            return shards, ([0] * n if with_padding else [])

        self._saved[cls] = {}
        for name, fn, new in (("local_shard_size_and_offset", size_fn,
                               sizes), ("_split_tensor", split_fn, split)):
            if fn is not None:
                self._saved[cls][name] = cls.__dict__[name]
                setattr(cls, name, new)
        return self

    def __exit__(self, *exc):
        for owner, fns in self._saved.items():
            for name, fn in fns.items():
                setattr(owner, name, fn)
        return False


def lower_cell(cfg: ModelConfig, shape: InputShape, mesh,
               microbatches: Optional[int] = None,
               mesh_name: Optional[str] = None) -> CellResult:
    """Run the cell's step once on the current (fake) world under
    ``FakeTensorMode``, as the rank of this process, and count its work.
    ``mesh_name`` names the mesh in the result (default: its shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    res = CellResult(arch=cfg.name, shape=shape.name,
                     mesh=mesh_name or _mesh_name(mesh),
                     kind=shape.kind, ok=False, n_devices=_n_devices(mesh))
    try:
        fn, args, in_sh, out_sh, _, n_micro = build_cell(
            cfg, shape, mesh, microbatches)
        res.microbatches = n_micro
        with FakeTensorMode(allow_non_fake_inputs=True):
            placed = tuple(_place(a, s) for a, s in zip(args, in_sh))
            arg_bytes = _local_bytes(placed)
            counter = LocalCounter()
            t0 = time.time()
            with shd.use_mesh(mesh), _FastStridedShard(), \
                    _NoCountDuringShapeInference(), counter:
                out = _place_out(fn(*placed), out_sh)
            res.lower_s = time.time() - t0
            out_bytes = _local_bytes(out)
        res.flops_per_dev = float(counter.flops)
        res.coll_detail = {"bytes_by_kind": dict(counter.coll_bytes),
                           "counts": dict(counter.coll_counts),
                           "total_bytes": sum(counter.coll_bytes.values())}
        res.coll_bytes_per_dev = float(res.coll_detail["total_bytes"])
        res.mem = {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(out_bytes)}
        res.ok = True
    except Exception as e:                     # noqa: BLE001
        res.error = f"{type(e).__name__}: {e}"[:2000]
    return res
