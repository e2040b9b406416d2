"""Carry parameters and optimizer state across from the JAX package.

``params_from_numpy(cfg, tree)`` takes the JAX package's parameter tree with
every leaf as a NumPy array (``np.asarray`` of each JAX array) and returns the
port's tree of tensors, leaf for leaf, checked against the port's own
``model_specs(cfg)``, on ``device`` (the card unless the caller asks for the
CPU). Values go through float32, so bf16 weights arrive bit-exact in bf16.

``opt_state_from_numpy(cfg, state)`` does the same for the JAX package's
AdamW state (``m``, ``v``, ``step``, and ``ef`` when present): f32 trees
checked against the parameters' specs and a 0-d int32 step, as the port's
``train.optimizer.init_state`` makes them.
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


def opt_state_from_numpy(cfg: ModelConfig, state: Dict[str, Any],
                         device: DeviceLike = None) -> Dict[str, Any]:
    device = resolve(device)
    out = {k: params_from_numpy(cfg, state[k], dtype=torch.float32,
                                device=device)
           for k in ("m", "v", "ef") if k in state}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=device)
    return out
