"""Checkpointing: atomic, manifest-driven save/restore of nested dicts of
tensors (or NumPy arrays and scalars) with optional async writes, ported
from the JAX package's ``checkpoint/checkpointer.py`` in its layout, so that
each package restores the other's checkpoints.

Layout:  <dir>/step_<N>/manifest.json + arrays.npz
Atomicity: written under step_<N>.tmp then renamed; readers only ever see
complete checkpoints. ``retain`` bounds disk usage; ``latest_step`` +
``restore`` implement the restart path.

Keys are the reference's: the path of dict keys to each leaf (in sorted
order, as ``jax.tree_util`` flattens a dict) joined by ``/``. ``save``
copies every tensor to host NumPy before it returns or starts its writer
thread, so the caller may reuse or overwrite its device tensors at once.
bf16 (which NumPy lacks) is widened to f32 on save, as the reference widens
it, and ``restore`` casts each array back to the dtype of the matching leaf
of ``like``, on ``device``; ``restore(..., shardings=...)`` places each leaf
on a (possibly different) device mesh instead, for elastic restarts.

A tree of DTensors is saved collectively: every rank gathers each leaf
(``full_tensor``, in the same order on every rank), rank 0 writes, and the
ranks meet at a barrier once the checkpoint is complete (after the write;
with ``async_save`` before the writer starts). The layout on disk is the
same either way.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.params import tree_unflatten


def _flatten_with_paths(tree, prefix: str = ""):
    """(keys, leaves) in the reference's order and naming: a leaf's key is
    its path of dict keys, sorted as ``jax.tree_util`` sorts them, joined
    by ``/``."""
    if not isinstance(tree, dict):
        return [prefix], [tree]
    keys, vals = [], []
    for k in sorted(tree):
        ks, vs = _flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix
                                     else str(k))
        keys += ks
        vals += vs
    return keys, vals


def _to_host(v) -> np.ndarray:
    """A host copy of one leaf (bf16 widened to f32); a DTensor is gathered
    whole first (a collective: every rank calls it)."""
    if shd.is_dtensor(v):
        v = v.full_tensor()
    if torch.is_tensor(v):
        dtype = torch.float32 if v.dtype == torch.bfloat16 else v.dtype
        return v.detach().to("cpu", dtype, copy=True).numpy()
    return np.array(v)


class Checkpointer:
    def __init__(self, directory: str, retain: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.retain = retain
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save ----
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        keys, vals = _flatten_with_paths(tree)
        host_vals = [_to_host(v) for v in vals]
        ranks = any(shd.is_dtensor(v) for v in vals)
        if ranks and torch.distributed.get_rank() != 0:
            torch.distributed.barrier()
            return
        if self.async_save:
            self.wait()
            if ranks:
                torch.distributed.barrier()
            self._thread = threading.Thread(
                target=self._write, args=(step, keys, host_vals, extra))
            self._thread.start()
        else:
            self._write(step, keys, host_vals, extra)
            if ranks:
                torch.distributed.barrier()

    def _write(self, step: int, keys: List[str], vals, extra):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": v for i, v in enumerate(vals)})
        manifest = {"step": step, "keys": keys,
                    "dtypes": [str(v.dtype) for v in vals],
                    "shapes": [list(v.shape) for v in vals],
                    "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.retain] if self.retain else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, name,
                                                "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, device: DeviceLike = None,
                shardings: Any = None) -> Any:
        """Restore into the structure of ``like``: each leaf that is a
        tensor there comes back as a new tensor of its dtype on ``device``
        (default: that leaf's device); any other leaf as a NumPy array.

        With ``shardings`` (a tree of ``sharding.NamedSharding`` shaped like
        ``like``, e.g. ``model_api.param_shardings``) each tensor leaf comes
        back as a DTensor on that mesh and placement, which may differ from
        the mesh that saved it; every rank reads the file and keeps its own
        slice (on ``device``, by default the mesh's device type)."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        keys_new, vals_like = _flatten_with_paths(like)
        shs = (_flatten_with_paths(shardings)[1] if shardings is not None
               else [None] * len(vals_like))
        out = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            by_key = {k: f"a{i}" for i, k in enumerate(manifest["keys"])}
            for k, v, sh in zip(keys_new, vals_like, shs):
                if k not in by_key:
                    raise KeyError(f"checkpoint missing key {k}")
                arr = data[by_key[k]]
                if torch.is_tensor(v) and sh is not None:
                    dev = (resolve(device) if device is not None
                           else torch.device(sh.mesh.device_type))
                    t = torch.from_numpy(arr).to(device=dev, dtype=v.dtype)
                    out.append(shd.distribute(t, sh))
                elif torch.is_tensor(v):
                    dev = v.device if device is None else resolve(device)
                    out.append(torch.from_numpy(arr).to(device=dev,
                                                        dtype=v.dtype))
                else:
                    want = getattr(v, "dtype", None)
                    out.append(arr if want is None else arr.astype(want))
        return tree_unflatten(like, out)

    def extra(self, step: int) -> Dict:
        path = os.path.join(self.dir, f"step_{step}", "manifest.json")
        with open(path) as f:
            return json.load(f)["extra"]
