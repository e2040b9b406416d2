"""Plain PyTorch oracle for the flash attention kernel: the twin of
``flash_attention_ref`` in the JAX package's ``kernels/ref.py``.

Deliberately naive (full (Sq, T) scores, f32): a correctness reference, not
a performance path.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,T,KH,D) -> (B,Sq,H,D). GQA by head grouping."""
    b, sq, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qr = q.reshape(b, sq, kh, g, d).float()
    scores = torch.einsum("bqkgd,btkd->bkgqt", qr, k.float()) * (d ** -0.5)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones(sq, t, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    scores = torch.where(ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
