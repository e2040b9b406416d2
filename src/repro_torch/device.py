"""Where the port runs: the CUDA card unless the caller asks for the CPU.

``resolve(None)`` is ``cuda``. A machine with no card raises
``NoCudaDevice``, naming the missing card; nothing carries on quietly on the
CPU. The CPU is used only when asked for by name (``device="cpu"``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


class NoCudaDevice(RuntimeError):
    """A CUDA device was asked for (or implied) and none is visible."""


def resolve(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(
            "no CUDA card (NVIDIA GPU) is visible to PyTorch "
            "(torch.cuda.is_available() is False); the port runs on the card "
            "by default; pass device='cpu' (or --device cpu) to run on the "
            "CPU")
    return dev


def generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """An explicit, seeded ``torch.Generator`` on the resolved device, for
    parameter initialisation (PyTorch's global RNG is never used)."""
    return torch.Generator(device=resolve(device)).manual_seed(seed)
