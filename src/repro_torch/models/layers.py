"""Core neural building blocks of the model families, ported from the JAX
package's ``models/layers.py``.

Activations enter and leave in the model dtype (bf16) while softmax and
normalization statistics are computed in f32, as in the JAX package.
Attention is position-mask based, so one function serves prefill and
full-cache decode. The JAX package's ``constrain`` calls are dropped: without
a device mesh they are no-ops, and one card has no mesh.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------- norms ----
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# ----------------------------------------------------------------- rope ----
def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,) or (B, S). NeoX half-split rotation."""
    d_half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(d_half, dtype=torch.float32,
                                   device=x.device) / d_half)
    if positions.ndim == 1:
        positions = positions[None, :]
    angle = positions[..., None].float() * freq            # (B,S,Dh)
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """Additive mask. q_pos: (B?,Sq). k_pos: (T,) or (B,T); -1 = empty slot."""
    if k_pos.ndim == 1:
        k_pos = k_pos[None, :]
    if q_pos.ndim == 1:
        q_pos = q_pos[None, :]
    q = q_pos[:, :, None].to(torch.int32)                  # (B,Sq,1)
    k = k_pos[:, None, :].to(torch.int32)                  # (B,1,T)
    ok = k >= 0
    if causal:
        ok = ok & (k <= q)
    if window is not None:
        ok = ok & (k > q - window)
    bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
    return bias[:, None, None, :, :]                       # (B,1,1,Sq,T)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, *,
           causal: bool = True, window: Optional[int] = None,
           softmax_scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention. q: (B,Sq,H,D); k,v: (B,T,KH,D). Returns (B,Sq,H,D) in
    v's dtype. Scores and softmax are f32 (the JAX package's
    ``preferred_element_type``); probabilities are cast to v's dtype for the
    second product, as there."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qr = q.reshape(b, sq, kh, g, d)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qr.float(), k.float()) * scale
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgqt,btkd->bqkgd", probs.to(v.dtype), v)
    return ctx.reshape(b, sq, h, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q0: int = 0, causal: bool = True,
                      window: Optional[int] = None,
                      q_chunk: int = 1024) -> torch.Tensor:
    """Loop over query blocks, touching only the kv range each block can see.

    q: (B,S,H,D) with absolute positions q0 + arange(S); k/v cover positions
    arange(T). Peak score memory is (B,KH,G,q_chunk,kv_width). Sliding-window
    attention reads a window+q_chunk slice per block; pure-causal attention
    reads the exact [0, (i+1)*q_chunk) prefix.
    """
    b, s, h, d = q.shape
    t = k.shape[1]
    dev = q.device
    if s <= q_chunk:
        return attend(q, k, v, q0 + torch.arange(s, device=dev),
                      torch.arange(t, device=dev), causal=causal,
                      window=window)
    if s % q_chunk:
        raise ValueError(f"sequence {s} is not a multiple of q_chunk "
                         f"{q_chunk}")
    nq = s // q_chunk
    outs = []
    if causal and window is not None and window + q_chunk < t:
        # fixed-width kv slice ending at this block's last row
        w_kv = window + q_chunk
        for i in range(nq):
            q_pos = q0 + i * q_chunk + torch.arange(q_chunk, device=dev)
            start = min(max((i + 1) * q_chunk - w_kv, 0), t - w_kv)
            k_pos = start + torch.arange(w_kv, device=dev)
            outs.append(attend(q[:, i * q_chunk:(i + 1) * q_chunk],
                               k[:, start:start + w_kv],
                               v[:, start:start + w_kv], q_pos, k_pos,
                               causal=True, window=window))
    elif causal and q0 == 0 and t == s:
        # exact causal prefixes
        for i in range(nq):
            hi = (i + 1) * q_chunk
            q_pos = i * q_chunk + torch.arange(q_chunk, device=dev)
            outs.append(attend(q[:, i * q_chunk:hi], k[:, :hi], v[:, :hi],
                               q_pos, torch.arange(hi, device=dev),
                               causal=True, window=window))
    else:
        k_pos = torch.arange(t, device=dev)
        for i in range(nq):
            q_pos = q0 + i * q_chunk + torch.arange(q_chunk, device=dev)
            outs.append(attend(q[:, i * q_chunk:(i + 1) * q_chunk], k, v,
                               q_pos, k_pos, causal=causal, window=window))
    return torch.cat(outs, dim=1)


# ------------------------------------------------------------------ mlp ----
def gated_mlp(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
              wo: torch.Tensor, act=F.silu) -> torch.Tensor:
    return (act(x @ wi) * (x @ wg)) @ wo


# ------------------------------------------------------------- qk norm -----
def qk_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm over head_dim (qwen3 style). x: (B,S,H,D)."""
    return rmsnorm(x, scale)


# ---------------------------------------------------------- conv (SSM) -----
def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C); w: (C,K). Returns (B,S,C) in x's
    dtype, computed in f32.

    Written as K shifted multiply-adds rather than ``F.conv1d``: on the card
    a float32 convolution goes through cuDNN in TF32 by default."""
    s, k = x.shape[1], w.shape[-1]
    xf, wf = x.float(), w.float()
    out = xf * wf[:, k - 1]
    for i in range(1, min(k, s + 1)):
        # tap k-1-i sees the input i steps back; the first i outputs see
        # the zero padding there
        out[:, i:] += xf[:, :s - i] * wf[:, k - 1 - i]
    return out.to(x.dtype)


def conv1d_step(x_t: torch.Tensor, buf: torch.Tensor,
                w: torch.Tensor):
    """Single-token causal conv with state buffer.

    x_t: (B,C); buf: (B,K-1,C) past inputs; w: (C,K). Returns (y_t (B,C) in
    x_t's dtype, new_buf). The window takes JAX's promotion of
    ``concat(buf, x_t)``, so the new buffer is f32 if either input is."""
    dt = torch.promote_types(buf.dtype, x_t.dtype)
    window = torch.cat([buf.to(dt), x_t[:, None, :].to(dt)], dim=1)
    y = torch.einsum("bkc,ck->bc", window.float(), w.float()).to(x_t.dtype)
    return y, window[:, 1:, :]


# ---------------------------------------------------------- kv cache -------
def masked_cache_update(cache: torch.Tensor, new: torch.Tensor,
                        slot: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B,1,KH,D) into per-row slots of ``cache`` (B,T,KH,D).

    Unlike the JAX package's masked select, which builds a new cache, this
    writes the B rows IN PLACE (one row scatter) and returns ``cache``: the
    JAX form rewrites the whole cache on every decode step.
    """
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot.long()] = new[:, 0].to(cache.dtype)
    return cache
