"""Unified model API of the port, dispatched on ``cfg.family`` as in the JAX
package's ``models/model_api.py``. The dense, hybrid (rglru) and SSM
(mamba2) families are wired; MoE, VLM and encoder-decoder raise
``NotImplementedError`` (ROADMAP.md, Queue 1).

  model_specs(cfg)                       -> Spec tree
  init_params(cfg, generator, device)    -> materialized params
  param_count(cfg)                       -> int
  prefill(cfg, params, batch)            -> (logits, cache)
  decode_step(cfg, params, cache, batch) -> (logits, cache)
  cache_specs / init_cache
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import DENSE, HYBRID, SSM, ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import params as pm
from repro_torch.models import mamba2, rglru
from repro_torch.models import transformer as tfm

_FAMILY_MODULES = {DENSE: tfm, HYBRID: rglru, SSM: mamba2}


def _mod(cfg: ModelConfig):
    mod = _FAMILY_MODULES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port serves the "
            f"{sorted(_FAMILY_MODULES)} families (see ROADMAP.md, Queue 1)")
    return mod


def model_specs(cfg: ModelConfig):
    return _mod(cfg).model_specs(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None):
    """Random-init bf16 parameters drawn from ``generator``, placed on
    ``device`` (the card unless the caller asks for the CPU)."""
    return pm.init(model_specs(cfg), generator, torch.bfloat16,
                   resolve(device))


def param_count(cfg: ModelConfig) -> int:
    return pm.count(model_specs(cfg))


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
