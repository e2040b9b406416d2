"""Architecture registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (ModelConfig, InputShape, ALL_SHAPES,
                                SHAPES_BY_NAME, shape_applicable)
from repro_torch.configs import (qwen3_1_7b, qwen3_0_6b, yi_34b, llama3_405b,
                           mixtral_8x7b, dbrx_132b, recurrentgemma_9b,
                           phi3_vision_4_2b, mamba2_2_7b, whisper_small)

_CONFIGS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen3_1_7b, qwen3_0_6b, yi_34b, llama3_405b, mixtral_8x7b,
              dbrx_132b, recurrentgemma_9b, phi3_vision_4_2b, mamba2_2_7b,
              whisper_small)
}

ARCH_IDS: List[str] = sorted(_CONFIGS)


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return _CONFIGS[arch]


def get_shape(name: str) -> InputShape:
    return SHAPES_BY_NAME[name]


def all_cells(include_skipped: bool = False):
    """Yield (config, shape, runnable, reason) for the 10x4 assignment grid."""
    for arch in ARCH_IDS:
        cfg = _CONFIGS[arch]
        for shape in ALL_SHAPES:
            ok, reason = shape_applicable(cfg, shape)
            if ok or include_skipped:
                yield cfg, shape, ok, reason
