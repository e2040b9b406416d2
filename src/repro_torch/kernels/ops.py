"""Public entry points of the port's kernels, dispatched on the tensors'
device: a CUDA tensor goes to the hand-written kernel, a CPU tensor to the
kernel's plain PyTorch version. Any other device raises.

``flash_attention`` keeps the signature of the JAX package's
``kernels/ops.py``. ``q_block``/``kv_block`` tile the plain version as they
tile the Pallas kernel; the CUDA kernel picks its own tiles, and both compute
the same function.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_block: int = 128, kv_block: int = 128) -> torch.Tensor:
    if q.device.type == "cuda":
        return _fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=causal,
                                        window=window)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, q_block=q_block,
                                         kv_block=kv_block)
    raise ValueError(f"flash_attention runs on cuda or cpu tensors; got "
                     f"{q.device}")
