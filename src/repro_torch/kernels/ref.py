"""Plain PyTorch oracles for the port's kernels: the twins of
``flash_attention_ref``, ``decode_attention_ref``, ``ssd_ref`` and
``rglru_ref`` in the JAX package's ``kernels/ref.py``.

Deliberately naive (full (Sq, T) scores, sequential recurrences, f32):
correctness references, not performance paths.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,H,D); k,v: (B,T,KH,D); lengths: (B,) valid prefix lengths."""
    b, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qr = q.reshape(b, kh, g, d).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qr, k.float()) * (d ** -0.5)
    mask = (torch.arange(t, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])                   # (B,T)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor,
            h0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence (the definitionally-correct oracle).

    x: (B,S,H,P); dt: (B,S,H) post-softplus; A: (H,)<0; Bm/Cm: (B,S,G,N).
    Returns (y: (B,S,H,P) f32, final_state: (B,H,P,N) f32).
    """
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hpg = h // g
    xf, dtf, af = x.float(), dt.float(), A.float()
    Bf = Bm.float().repeat_interleave(hpg, dim=2)          # (B,S,H,N)
    Cf = Cm.float().repeat_interleave(hpg, dim=2)
    state = (h0.float() if h0 is not None
             else torch.zeros(b, h, p, n, device=x.device))
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af[None, :])          # (B,H)
        state = (state * decay[..., None, None]
                 + (dtf[:, t, :, None] * xf[:, t])[..., None]
                 * Bf[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1), state


def rglru_ref(a: torch.Tensor, b: torch.Tensor,
              h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential linear recurrence h_t = a_t*h_{t-1} + b_t. a,b: (B,S,W)."""
    bs, s, w = a.shape
    h = (h0.float() if h0 is not None
         else torch.zeros(bs, w, device=a.device))
    af, bf = a.float(), b.float()
    hs = []
    for t in range(s):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
