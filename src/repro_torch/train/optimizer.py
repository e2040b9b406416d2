"""AdamW with global-norm clipping, a cosine LR schedule and optional int8
gradient compression with error feedback, ported from the JAX package's
``train/optimizer.py``.

The state is ``{"m", "v", "step"}`` (+ ``"ef"`` with ``compress_grads``):
m and v are f32 trees shaped like the parameters, ``step`` a 0-d int32
tensor. The update follows the reference's order of operations, so the same
gradients give the same f32 arithmetic: the gradient cast to f32, the clip
factor ``min(1, clip_norm / max(gnorm, 1e-12))``, m then v, the bias
corrections as f32 powers of the step, the weight decay inside the step's
``delta``, and the cast back to each parameter's dtype.

ZeRO-1: m and v additionally shard a replicated dim over the data-parallel
axes (the ``"zero"`` logical axis, ``_zero_spec``), and ``state_shardings``
places them so on a mesh. Under a mesh the update runs on DTensors: the
gradients' pending sums are reduced where DTensor's rules put them, and the
train step hands each new leaf back in its input's placement.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import sharding as shd
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import params as pm


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False     # int8 gradients with error feedback


def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac * lr``
    at ``total_steps``; f32, as the reference computes it."""
    step = step.float()
    warm = step / max(oc.warmup_steps, 1)
    t = (step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 * (
        1 + torch.cos(torch.pi * t))
    return oc.lr * torch.where(step < oc.warmup_steps, warm, cos)


# ---------------------------------------------------------------------------
# State declaration
# ---------------------------------------------------------------------------


def _zero_spec(s: pm.Spec) -> pm.Spec:
    """ZeRO-1: optimizer state sharded over the data axes on the largest
    effectively-replicated dim (see params.fsdp_spec)."""
    z = pm.fsdp_spec(s)
    return pm.Spec(z.shape, z.axes, "zeros")


def state_specs(model_spec_tree) -> Dict[str, Any]:
    """Spec trees of the state: m and v shaped like the parameters on the
    ZeRO axis, ef on the parameters' axes, all zero-initialised."""
    mv = pm.tree_map(_zero_spec, model_spec_tree)
    ef = pm.tree_map(lambda s: pm.Spec(s.shape, s.axes, "zeros"),
                     model_spec_tree)
    return {"m": mv, "v": mv, "ef": ef, "step": pm.Spec((), (), "zeros")}


def init_state(oc: OptConfig, model_spec_tree,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zero state on ``device`` (the card unless the caller asks for the
    CPU): f32 m and v (and ef with ``compress_grads``), step 0."""
    dev = resolve(device)
    spec = state_specs(model_spec_tree)

    def zeros(tree):
        return pm.tree_map(
            lambda s: torch.zeros(s.shape, dtype=torch.float32, device=dev),
            tree)

    out = {"m": zeros(spec["m"]), "v": zeros(spec["v"]),
           "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if oc.compress_grads:
        out["ef"] = zeros(spec["ef"])
    return out


def state_shardings(oc: OptConfig, model_spec_tree, mesh):
    """Where each leaf of the state lives on ``mesh``: m and v on the ZeRO
    axis, ``step`` replicated (and ef as the parameters)."""
    spec = state_specs(model_spec_tree)
    out = {"m": pm.shardings(spec["m"], mesh),
           "v": pm.shardings(spec["v"], mesh),
           "step": shd.named_sharding(mesh, (), ())}
    if oc.compress_grads:
        out["ef"] = pm.shardings(spec["ef"], mesh)
    return out


# ---------------------------------------------------------------------------
# Gradient compression (int8 + error feedback)
# ---------------------------------------------------------------------------


def compress_decompress(g: torch.Tensor, ef: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize g+ef to int8 with one per-tensor scale, return (g_hat,
    new_ef). ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    gf = g.float() + ef
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    g_hat = q.float() * scale
    return g_hat, gf - g_hat


# ---------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, the leaves in the
    reference's order (sorted dict keys)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in pm.tree_leaves(tree)))


@torch.no_grad()
def apply_updates(oc: OptConfig, params, grads, state
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (new params, new state, {"lr", "grad_norm"});
    the inputs are left as they were (new tensors throughout)."""
    step = state["step"] + 1
    lr = schedule(oc, step)

    if oc.compress_grads:
        pairs = pm.tree_map(compress_decompress, grads, state["ef"])
        grads = pm.tree_map(lambda p: p[0], pairs)
        new_ef = pm.tree_map(lambda p: p[1], pairs)

    gnorm = global_norm(grads)
    clip = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    stepf = step.float()
    b1c = 1 - torch.pow(torch.tensor(oc.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(oc.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(p, g, m, v):
        g = g.float() * clip
        m = oc.b1 * m + (1 - oc.b1) * g
        v = oc.b2 * v + (1 - oc.b2) * torch.square(g)
        mhat, vhat = m / b1c, v / b2c
        delta = mhat / (torch.sqrt(vhat) + oc.eps) + \
            oc.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    triples = pm.tree_map(upd, params, grads, state["m"], state["v"])
    new_p = pm.tree_map(lambda t: t[0], triples)
    new_m = pm.tree_map(lambda t: t[1], triples)
    new_v = pm.tree_map(lambda t: t[2], triples)
    new_state = {"m": new_m, "v": new_v, "step": step}
    if oc.compress_grads:
        new_state["ef"] = new_ef
    return new_p, new_state, {"lr": lr, "grad_norm": gnorm}
