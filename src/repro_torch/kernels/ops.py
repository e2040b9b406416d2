"""Public entry points of the port's kernels, dispatched on the tensors'
device: a CUDA tensor goes to the hand-written kernel, a CPU tensor to the
kernel's plain PyTorch version. Any other device raises.

``flash_attention``, ``decode_attention``, ``ssd_scan`` and ``rglru_scan``
keep the signatures of the JAX package's ``kernels/ops.py``. ``q_block``/
``kv_block`` tile the plain flash attention as they tile the Pallas kernel;
``splits``/``kv_block`` split the plain decode attention as they split the
Pallas kernel, and on both routes decide which cache lengths are accepted
(the reference's rule, ``decode_attention.split_rule``); ``chunk`` is the SSD
scan's chunk on both routes. The CUDA kernels pick their own tiles and
splits, and ``rglru_scan``'s ``chunk``/``width_block`` (tiles of the Pallas
kernel) tile neither route: the recurrence is the same function whatever the
tiling.

None of the four has a backward, in the JAX package (no ``custom_vjp``) as
here: a CUDA kernel's output has no ``grad_fn``, so autograd would pass no
gradient upstream of it. Each entry point raises when grad mode is on and an
input requires grad, on the card and on the CPU alike, so that a CPU test
sees what the card does. Training runs the plain routes
(``cfg.use_pallas=False``), as the JAX package's does.

On a device mesh ``flash_attention``, ``ssd_scan`` and ``rglru_scan`` take
DTensors through one ``local_map``-style wrapper (``sharding.local_shards``): each
rank runs the kernel (on the card) or its plain version (on the CPU) on its
local shard, and the outputs are DTensors laid out as the inputs. That is
sound only over the dimensions a kernel treats independently: the batch;
the heads for flash attention and the SSD scan; the columns for the RG-LRU
scan. A placement that shards anything else (the sequence, head_dim, the
SSD state N) raises. Where the query heads are sharded and the kv heads (or
the SSD groups) are not, each rank narrows them to those its heads use.
``decode_attention`` is on no mesh path and takes plain tensors only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import sharding as shd
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import ssd_scan as _ssd


def _no_backward(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward; train with "
                           f"use_pallas=False")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_block: int = 128, kv_block: int = 128) -> torch.Tensor:
    _no_backward("flash_attention", q, k, v)
    if any(shd.is_dtensor(t) for t in (q, k, v)):
        return shd.local_shards(
            "flash_attention",
            lambda q, k, v: flash_attention(q, k, v, causal=causal,
                                            window=window, q_block=q_block,
                                            kv_block=kv_block),
            (q, k, v), (("b", None, "h", None), ("b", None, "g", None),
                        ("b", None, "g", None)), ({0: 0, 2: 2},))
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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, splits: int = 4,
                     kv_block: int = 128) -> torch.Tensor:
    _no_backward("decode_attention", q, k, v)
    if q.device.type == "cuda":
        return _da.decode_attention_cuda(q.contiguous(), k.contiguous(),
                                         v.contiguous(),
                                         lengths.to(torch.int32),
                                         splits=splits, kv_block=kv_block)
    if q.device.type == "cpu":
        return _da.decode_attention_plain(q, k, v, lengths, splits=splits,
                                          kv_block=kv_block)
    raise ValueError(f"decode_attention runs on cuda or cpu tensors; got "
                     f"{q.device}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    _no_backward("ssd_scan", x, dt, A, Bm, Cm)
    if any(shd.is_dtensor(t) for t in (x, dt, A, Bm, Cm)):
        return shd.local_shards(
            "ssd_scan",
            lambda *a: ssd_scan(*a, chunk=chunk), (x, dt, A, Bm, Cm),
            (("b", None, "h", None), ("b", None, "h"), ("h",),
             ("b", None, "g", None), ("b", None, "g", None)),
            ({0: 0, 2: 2}, {0: 0, 2: 1}))
    if x.device.type == "cuda":
        return _ssd.ssd_scan_cuda(x.contiguous(), dt.float().contiguous(),
                                  A.float().contiguous(), Bm.contiguous(),
                                  Cm.contiguous(), chunk=chunk)
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    raise ValueError(f"ssd_scan runs on cuda or cpu tensors; got {x.device}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor, *, chunk: int = 64,
               width_block: int = 128) -> torch.Tensor:
    del chunk, width_block
    _no_backward("rglru_scan", a, b)
    if shd.is_dtensor(a) or shd.is_dtensor(b):
        return shd.local_shards("rglru_scan", rglru_scan, (a, b),
                                (("b", None, "h"), ("b", None, "h")),
                                ({0: 0, 2: 2},))
    if a.device.type == "cuda":
        return _rglru.rglru_scan_cuda(a.float().contiguous(),
                                      b.float().contiguous())
    if a.device.type == "cpu":
        return _rglru.rglru_scan_plain(a, b)
    raise ValueError(f"rglru_scan runs on cuda or cpu tensors; got "
                     f"{a.device}")
