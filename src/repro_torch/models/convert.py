"""Carry parameters across from the JAX package.

``params_from_numpy(cfg, tree)`` takes the JAX package's parameter tree with
every leaf as a NumPy array (``np.asarray`` of each JAX array) and returns the
port's tree of tensors, leaf for leaf, checked against the port's own
``model_specs(cfg)``, on ``device`` (the card unless the caller asks for the
CPU). Values go through float32, so bf16 weights arrive bit-exact in bf16.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import model_api as api


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      dtype: torch.dtype = torch.bfloat16,
                      device: DeviceLike = None) -> Dict[str, Any]:
    specs = api.model_specs(cfg)
    device = resolve(device)

    def go(spec, leaf, path):
        if isinstance(spec, dict):
            if not isinstance(leaf, dict) or set(leaf) != set(spec):
                got = sorted(leaf) if isinstance(leaf, dict) else type(leaf)
                raise ValueError(f"{path or 'params'}: want keys "
                                 f"{sorted(spec)}, got {got}")
            return {k: go(spec[k], leaf[k], f"{path}/{k}") for k in spec}
        arr = np.asarray(leaf).astype(np.float32)
        if arr.shape != spec.shape:
            raise ValueError(f"{path}: want shape {spec.shape}, got "
                             f"{arr.shape}")
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    return go(specs, tree, "")
