"""Single-source-of-truth parameter declaration, as in the JAX package.

Each model family declares its parameters once as a nested dict of ``Spec``
leaves (shape + logical axes + initializer). From that tree the port derives
``init(tree, generator)`` (materialized tensors) and ``count(tree)``. The
stacked leading ``layers`` dimension is kept, so the port's tree matches the
JAX package's leaf for leaf.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import sharding as shd


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | lru_a | ssm_a |
                                # ssm_dt | pos
    scale: float = 1.0          # multiplier on fan-in-scaled normal


def tree_map(f: Callable[..., Any], tree, *rest):
    """Map ``f`` over the leaves (Specs or tensors) of a nested dict, and
    over the matching leaves of the ``rest`` trees beside it."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return f(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the JAX package's flattening order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure whose leaves are ``leaves``, taken
    in ``tree_leaves``' order."""
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        return next(it)

    return go(like)


def tree_index(tree, i: int):
    """Slice i of every leaf of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


def stack(n: int, tree):
    """Prepend a stacked 'layers' dim of size n to every Spec in the tree."""
    return tree_map(
        lambda s: Spec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale),
        tree)


def abstract(tree, dtype=torch.bfloat16):
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), tree)


def shardings(tree, mesh):
    return tree_map(lambda s: shd.named_sharding(mesh, s.shape, s.axes), tree)


def pspecs(tree, mesh):
    return tree_map(lambda s: shd.spec_for(mesh, s.shape, s.axes), tree)


def distribute(tree, sharding_tree):
    """Every leaf of ``tree`` (the same full tensors on every rank) placed
    by the matching leaf of ``sharding_tree``."""
    return tree_map(shd.distribute, tree, sharding_tree)


# (low, high, transform) of the uniform initialisers, as in the JAX package's
# params.py: RG-LRU Lambda (a in [0.9, 0.999], Lambda = softplus^-1 of
# -log(a)/8), Mamba-2 A_log (A in [1, 16)) and dt bias (softplus^-1 of dt,
# log dt uniform in [log 1e-3, log 1e-1]).
_UNIFORM = {
    "lru_a": (0.9, 0.999, lambda u: torch.log(torch.expm1(-torch.log(u)
                                                          / 8.0))),
    "ssm_a": (1.0, 16.0, torch.log),
    "ssm_dt": (math.log(1e-3), math.log(1e-1),
               lambda u: torch.log(torch.expm1(torch.exp(u)))),
}


# the most elements a leaf draws in one f32 tensor (8 GiB)
_ONE_DRAW = 2 ** 31


def _init_leaf(s: Spec, generator: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dtype, device=device)
    if s.init in _UNIFORM:
        # a uniform draw in f32, then the JAX package's transform
        lo, hi, transform = _UNIFORM[s.init]
        u = torch.rand(s.shape, generator=generator, dtype=torch.float32,
                       device=generator.device) * (hi - lo) + lo
        return transform(u).to(device=device, dtype=dtype)
    if s.init == "pos":
        # learned positional embeddings (whisper's encoder): a small normal
        std = 0.02
    elif s.init == "normal":
        # fan-in scaled normal, drawn in f32 and then cast, as the JAX package
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.scale / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown initializer {s.init!r}")
    if math.prod(s.shape) <= _ONE_DRAW:
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (std * x).to(device=device, dtype=dtype)
    # a leaf whose f32 draw would not fit beside the model on the card
    # (mixtral-8x7b's stacked experts: 45 GB in f32) is drawn one slice of
    # its leading axis at a time
    out = torch.empty(s.shape, dtype=dtype, device=device)
    for i in range(s.shape[0]):
        x = torch.randn(s.shape[1:], generator=generator, dtype=torch.float32,
                        device=generator.device)
        out[i] = (std * x).to(device=device, dtype=dtype)
    return out


def init(tree, generator: torch.Generator, dtype=torch.bfloat16,
         device=None):
    """Materialize every leaf, drawing in the JAX package's leaf order from
    ``generator`` (on its own device) and placing the result on ``device``
    (default: the generator's device)."""
    device = torch.device(device) if device is not None else generator.device

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        return _init_leaf(t, generator, dtype, device)

    return go(tree)


def count(tree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(tree))


def fsdp_spec(s: Spec) -> Spec:
    """Add the data-parallel ("zero") axis to the largest effectively-
    replicated dim — FSDP-style parameter sharding (and the ZeRO-1 transform
    for optimizer states). Needed to FIT models like llama3-405b whose
    tensor-parallel-only shards exceed a device's memory."""
    axes = list(s.axes)
    best, best_dim = None, 0
    for i, (d, a) in enumerate(zip(s.shape, axes)):
        replicated = a is None or not any(shd.RULES.get(a, ()))
        if replicated and d > best_dim:
            best, best_dim = i, d
    if best is not None:
        axes[best] = "zero"
    return Spec(s.shape, tuple(axes), s.init, s.scale)
