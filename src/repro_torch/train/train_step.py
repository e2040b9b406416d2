"""The functions that make the training and serving steps, ported from the
JAX package's ``train/train_step.py``: what the trainer and the quickstart
call.

``train_step``: forward + backward (+ gradient accumulation over
microbatches) + the AdamW update. ``prefill_step`` / ``serve_step``: the
inference entry points, run without autograd.

Steps run eagerly. The reference compiles them with ``jax.jit``; the port has
no counterpart yet (CUDA graphs are ROADMAP.md's item 10). The backward pass
is autograd's through the plain routes: the kernel entry points have no
backward and raise under autograd (``kernels/ops.py``), as the reference's
Pallas kernels have none, so train with ``cfg.use_pallas=False``.

On a device mesh (``sharding.use_mesh``) the step takes DTensors placed by
``model_api.param_shardings`` / ``optimizer.state_shardings`` /
``model_api.batch_shardings`` and hands every new parameter and state leaf
back in its input's placement, as the reference's ``out_shardings`` do;
the metrics come back replicated.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import sharding as shd
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import model_api as api
from repro_torch.models import params as pm
from repro_torch.train import optimizer as opt


def _rows(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of ``v``'s rows: consecutive rows of the
    whole batch, as the reference's reshape to (n, B // n, ...) splits
    them. Of a DTensor, the same global rows, placed as the batch is
    (``sharding.take_rows``): the masked mean and the MoE load-balancing
    loss of a microbatch depend on which rows it holds."""
    m = v.shape[0] // n
    return shd.take_rows(v, i * m, (i + 1) * m)


def _split_microbatches(batch: Dict, n: int):
    return [{k: _rows(v, i, n) for k, v in batch.items()} for i in range(n)]


def _placed_like(new, old):
    """``new`` redistributed to ``old``'s placements (DTensor leaves)."""
    if not shd.is_dtensor(old) or tuple(new.placements) == tuple(
            old.placements):
        return new
    return new.redistribute(old.device_mesh, old.placements)


def _value_and_grad(cfg: ModelConfig, params, mb: Dict):
    """(loss, metrics, grads): autograd's gradient of ``loss_fn`` (with
    remat) for every parameter leaf, in the leaf's dtype."""
    live = [p.detach().requires_grad_() for p in pm.tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = api.loss_fn(cfg, pm.tree_unflatten(params, live), mb,
                                    remat=True)
        grads = torch.autograd.grad(loss, live)
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, pm.tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, oc: opt.OptConfig,
                    num_microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics). With ``num_microbatches`` > 1 the gradients are summed in f32
    over the microbatches and divided by their number, and the loss is
    their mean, as the reference's ``lax.scan`` does."""

    def train_step(params, opt_state, batch):
        if num_microbatches > 1:
            grads, lsum = None, 0.0
            for mb in _split_microbatches(batch, num_microbatches):
                l, _, g = _value_and_grad(cfg, params, mb)
                grads = (pm.tree_map(lambda a: a.float(), g) if grads is None
                         else pm.tree_map(lambda a, b: a + b.float(), grads,
                                          g))
                lsum = lsum + l
                del g
            grads = pm.tree_map(lambda g: g / num_microbatches, grads)
            loss = lsum / num_microbatches
        else:
            loss, _, grads = _value_and_grad(cfg, params, batch)
        new_params, new_state, om = opt.apply_updates(oc, params, grads,
                                                      opt_state)
        new_params = pm.tree_map(_placed_like, new_params, params)
        new_state = pm.tree_map(_placed_like, new_state, opt_state)
        metrics = {"loss": loss, **om}
        return new_params, new_state, {k: shd.settle(v)
                                       for k, v in metrics.items()}

    return train_step


def make_prefill_step(cfg: ModelConfig, context_len: Optional[int] = None):
    @torch.no_grad()
    def prefill_step(params, batch):
        return api.prefill(cfg, params, batch, context_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: new token for every sequence, cache in/out."""
    @torch.no_grad()
    def serve_step(params, cache, batch):
        return api.decode_step(cfg, params, cache, batch)
    return serve_step


def default_microbatches(cfg: ModelConfig, shape: InputShape,
                         n_chips: int) -> int:
    """Activation-memory heuristic: keep saved layer inputs under ~2 GiB a
    chip.

    With remat='dots', per-layer live activations ~= batch*seq*d_model*2B
    (+ MoE dispatch buffers); we bound sum over layers / chips.
    """
    if shape.kind != "train":
        return 1
    depth = cfg.num_layers
    bytes_per_layer = shape.global_batch * shape.seq_len * cfg.d_model * 2
    total = bytes_per_layer * max(depth, 1)
    budget = 2 * (1 << 30) * n_chips
    n = max(1, int(-(-total // budget)))
    # round to a divisor of global_batch
    while shape.global_batch % n:
        n += 1
    return min(n, shape.global_batch)
