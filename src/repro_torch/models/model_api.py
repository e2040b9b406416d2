"""Unified model API of the port, dispatched on ``cfg.family`` as in the JAX
package's ``models/model_api.py``: every family of the JAX package is wired
(dense, MoE and VLM through ``transformer``, the hybrid through ``rglru``,
the SSM through ``mamba2``, encoder-decoder through ``whisper``).

  model_specs(cfg)                       -> Spec tree
  abstract_params(cfg)                   -> meta tensors (no storage)
  init_params(cfg, generator, device)    -> materialized params
  param_shardings / param_pspecs(cfg, mesh) -> where each leaf lives
  param_count(cfg)                       -> int
  loss_fn(cfg, params, batch)            -> (scalar loss, metrics)
  prefill(cfg, params, batch)            -> (logits, cache)
  decode_step(cfg, params, cache, batch) -> (logits, cache)
  cache_specs / init_cache / abstract_cache / cache_shardings / cache_pspecs
  make_batch(cfg, shape, rng, device)    -> concrete batch
  batch_specs / decode_batch_specs / input_specs / batch_shardings

The serving engine feeds ``tokens`` and ``prompt_lens`` only, as the JAX
engine does, so it serves the dense, MoE, hybrid and SSM families; the VLM
(``image_embeds``) and encoder-decoder (``frames``) families run through
``prefill``/``decode_step`` with a ``make_batch`` batch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (DENSE, ENCDEC, HYBRID, MOE, SSM, VLM,
                                      InputShape, ModelConfig)
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import layers as nn
from repro_torch.models import params as pm
from repro_torch.models import mamba2, rglru, whisper
from repro_torch.models import transformer as tfm
from repro_torch.sharding import constrain, settle

_FAMILY_MODULES = {DENSE: tfm, MOE: tfm, VLM: tfm, HYBRID: rglru,
                   SSM: mamba2, ENCDEC: whisper}


def _mod(cfg: ModelConfig):
    return _FAMILY_MODULES[cfg.family]


def model_specs(cfg: ModelConfig):
    return _mod(cfg).model_specs(cfg)


def abstract_params(cfg: ModelConfig):
    return pm.abstract(model_specs(cfg), torch.bfloat16)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None):
    """Random-init bf16 parameters drawn from ``generator``, placed on
    ``device`` (the card unless the caller asks for the CPU)."""
    return pm.init(model_specs(cfg), generator, torch.bfloat16,
                   resolve(device))


def _sharding_specs(cfg: ModelConfig):
    tree = model_specs(cfg)
    if cfg.param_fsdp:
        tree = pm.tree_map(pm.fsdp_spec, tree)
    return tree


def param_shardings(cfg: ModelConfig, mesh):
    return pm.shardings(_sharding_specs(cfg), mesh)


def param_pspecs(cfg: ModelConfig, mesh):
    return pm.pspecs(_sharding_specs(cfg), mesh)


def param_count(cfg: ModelConfig) -> int:
    return pm.count(model_specs(cfg))


# --------------------------------------------------------------- loss ------
def _lm_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over the positions ``mask`` keeps, the
    log-sum-exp taken over f32 logits."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = settle(torch.gather(logits, -1, labels.long()[..., None]))
    gold = gold[..., 0]
    ce = (lse - gold) * mask
    return ce.sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict,
            remat: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE (+ MoE aux) for every family, as the JAX package's.
    ``batch``: ``tokens``, ``labels`` and ``mask`` (B, S), plus
    ``image_embeds`` for the VLM (whose loss covers the text positions
    only) and ``frames`` for encoder-decoder. With ``remat`` each layer of
    the stack runs under ``cfg.remat``'s checkpointing."""
    if cfg.family == ENCDEC:
        logits = whisper.decode_train(
            cfg, params, batch["tokens"],
            whisper.encode(cfg, params, batch["frames"]), remat=remat)
        loss = _lm_loss(cfg, logits, batch["labels"], batch["mask"])
        return loss, {"ce": loss, "aux": 0.0}

    if cfg.family in (DENSE, MOE, VLM):
        embeds = tfm.embed_inputs(cfg, params, batch)
        h, _, aux = tfm.forward_hidden(cfg, params, embeds, remat=remat)
        if cfg.family == VLM:                    # loss over text positions
            h = h[:, cfg.n_img_tokens:, :]
    elif cfg.family in (HYBRID, SSM):
        embeds = constrain(nn.embed(params["embed"], batch["tokens"]),
                           "batch", None, "embed")
        h, _, aux = _mod(cfg).forward_hidden(cfg, params, embeds,
                                             remat=remat)
    else:
        raise ValueError(cfg.family)
    logits = tfm.logits_fn(cfg, params, h)
    ce = _lm_loss(cfg, logits, batch["labels"], batch["mask"])
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(cfg: ModelConfig, params: Dict, batch: Dict,
            context_len: Optional[int] = None):
    return _mod(cfg).prefill(cfg, params, batch, context_len)


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, batch: Dict):
    return _mod(cfg).decode_step(cfg, params, cache, batch)


def cache_specs(cfg: ModelConfig, batch_size: int, context_len: int):
    return _mod(cfg).cache_specs(cfg, batch_size, context_len)


def init_cache(cfg: ModelConfig, batch_size: int, context_len: int,
               device: DeviceLike = None):
    return _mod(cfg).init_cache(cfg, batch_size, context_len,
                                device=resolve(device))


def abstract_cache(cfg: ModelConfig, batch_size: int, context_len: int):
    """Meta tensors with the shapes and dtypes ``init_cache`` gives."""
    return init_cache(cfg, batch_size, context_len, device="meta")


def cache_shardings(cfg: ModelConfig, mesh, batch_size: int,
                    context_len: int):
    return pm.shardings(cache_specs(cfg, batch_size, context_len), mesh)


def cache_pspecs(cfg: ModelConfig, mesh, batch_size: int, context_len: int):
    return pm.pspecs(cache_specs(cfg, batch_size, context_len), mesh)


# ------------------------------------------------------------- inputs ------
def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    return seq_len - cfg.n_img_tokens if cfg.family == VLM else seq_len


def batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, pm.Spec]:
    """Spec tree for a train/prefill batch (decode handled separately)."""
    b = shape.global_batch
    s = _text_len(cfg, shape.seq_len)
    out = {"tokens": pm.Spec((b, s), ("batch", None), "zeros")}
    if shape.kind == "train":
        out["labels"] = pm.Spec((b, s), ("batch", None), "zeros")
        out["mask"] = pm.Spec((b, s), ("batch", None), "ones")
    if cfg.family == VLM:
        out["image_embeds"] = pm.Spec((b, cfg.n_img_tokens, cfg.d_model),
                                      ("batch", None, "embed"))
    if cfg.family == ENCDEC:
        out["frames"] = pm.Spec((b, cfg.n_enc_frames, cfg.d_model),
                                ("batch", None, "embed"))
    return out


def decode_batch_specs(cfg: ModelConfig, shape: InputShape):
    return {"token": pm.Spec((shape.global_batch, 1), ("batch", None),
                             "zeros")}


# the JAX package's batch dtypes (token ids int32): what ``input_specs``
# declares, so that a dry-run's argument bytes compare with the reference's;
# ``make_batch`` feeds int64 ids, which indexing takes as they are
_BATCH_DTYPES = {"tokens": torch.int32, "labels": torch.int32,
                 "token": torch.int32, "mask": torch.float32,
                 "image_embeds": torch.bfloat16, "frames": torch.bfloat16}


def _batch_tree(cfg: ModelConfig, shape: InputShape):
    return (decode_batch_specs(cfg, shape) if shape.kind == "decode"
            else batch_specs(cfg, shape))


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Meta-tensor stand-ins of a batch (no storage)."""
    return {k: torch.empty(s.shape, dtype=_BATCH_DTYPES[k], device="meta")
            for k, s in _batch_tree(cfg, shape).items()}


def batch_shardings(cfg: ModelConfig, mesh, shape: InputShape):
    return pm.shardings(_batch_tree(cfg, shape), mesh)


def make_batch(cfg: ModelConfig, shape: InputShape,
               rng: Optional[np.random.Generator] = None,
               batch: Optional[int] = None, seq: Optional[int] = None,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A concrete random batch, drawn from the numpy ``rng`` in the JAX
    package's order (the same seed gives the same values there): token ids
    (int64 here, int32 there), for a VLM the ``image_embeds`` (B,
    n_img_tokens, d_model) in front of ``seq - n_img_tokens`` text tokens,
    for encoder-decoder the ``frames`` (B, n_enc_frames, d_model), both
    ``normal * 0.02`` in bf16; on ``device`` (the card unless the caller
    asks for the CPU)."""
    dev = resolve(device)
    rng = rng if rng is not None else np.random.default_rng(0)
    b = batch or shape.global_batch
    s = _text_len(cfg, seq or shape.seq_len)

    def ids(shape_):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape_)).to(
            device=dev, dtype=torch.int64)

    def embeds(n):
        x = rng.normal(size=(b, n, cfg.d_model)) * 0.02
        return torch.from_numpy(x).to(device=dev, dtype=torch.bfloat16)

    if shape.kind == "decode":
        return {"token": ids((b, 1))}
    out = {"tokens": ids((b, s))}
    if shape.kind == "train":
        out["labels"] = ids((b, s))
        out["mask"] = torch.ones((b, s), dtype=torch.float32, device=dev)
    if cfg.family == VLM:
        out["image_embeds"] = embeds(cfg.n_img_tokens)
    if cfg.family == ENCDEC:
        out["frames"] = embeds(cfg.n_enc_frames)
    return out
