"""Core neural building blocks of the model families, ported from the JAX
package's ``models/layers.py``.

Activations enter and leave in the model dtype (bf16) while softmax and
normalization statistics are computed in f32, as in the JAX package.
Attention is position-mask based, so one function serves prefill and
full-cache decode. ``constrain`` sits where the JAX package has it; without
a mesh installed it is the identity.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import (constrain, is_dtensor, local_shardable,
                                  local_shards, match_heads, settle,
                                  settle_grad)

NEG_INF = -1e30


# ---------------------------------------------------------------- norms ----
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def pre_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``rmsnorm`` of a block's input (B,S,D) that feeds its products. On a
    mesh the norm runs on the sequence-sharded input and its output is
    gathered to the whole sequence (Megatron sequence parallelism's
    all-gather): DTensor would otherwise flatten a batch- and
    sequence-sharded activation into a strided shard for every product,
    whose redistribution it plans by a search over placements. The values
    are the same."""
    return constrain(rmsnorm(x, scale), "batch", None, "embed")


def to_residual(cfg, y: torch.Tensor) -> torch.Tensor:
    """A block's output (B,S,D), before it is added to the residual stream,
    in the stream's placement (the layer boundary's: the sequence sharded
    with ``cfg.seq_parallel``). On a mesh this is the reduce-scatter of the
    row-parallel product's partial sums, done on the 3-d tensor, so that its
    gradient comes back whole over "model" (DTensor would otherwise flatten
    a sequence-sharded gradient into a strided shard). The values are the
    same."""
    return constrain(y, "batch", "seq_sp" if cfg.seq_parallel else None,
                     "embed")


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
    second product, as there.

    On DTensors sharded on the batch and heads only, each rank attends over
    its own rows and heads (``sharding.local_shards``: heads are
    independent; a kv head replicated where the query heads are sharded is
    narrowed to the ones the rank's heads use): DTensor would merge a
    batch and a head dim sharded over different mesh dims into a strided
    shard for each product. Any other placement (a decode cache sharded on
    its sequence) runs on the DTensors, the query heads replicated where
    the kv heads are not sharded alike (``sharding.match_heads``)."""
    if is_dtensor(q):
        args = (q, k, v, q_pos, k_pos)
        roles = (("b", None, "h", None), ("b", None, "g", None),
                 ("b", None, "g", None),
                 *[("b", None) if t.ndim == 2 else (None,)
                   for t in (q_pos, k_pos)])
        if local_shardable(args, roles):
            return local_shards(
                "attend", lambda *a: attend(
                    *a, causal=causal, window=window,
                    softmax_scale=softmax_scale), args, roles, ({0: 0, 2: 2},))
    placed = q.placements if is_dtensor(q) else None
    q, k, v = match_heads(q, k, v)
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qr = q.reshape(b, sq, kh, g, d)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qr.float(), k.float()) * scale
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgqt,btkd->bqkgd", probs.to(v.dtype), v)
    ctx = ctx.reshape(b, sq, h, d)
    if placed is not None:
        # back in q's shards where match_heads replicated them; the gradient
        # then comes back whole to the head reshape above, which could not
        # split it by kv head
        want = [p if p.is_shard() and c.is_replicate() else c
                for p, c in zip(placed, ctx.placements)]
        if want != list(ctx.placements):
            ctx = ctx.redistribute(ctx.device_mesh, want)
    return ctx


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


# ------------------------------------------------------------ embedding ---
def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``table`` (the JAX package's ``jnp.take``). A DTensor
    table whose vocabulary is sharded goes through ``F.embedding``,
    DTensor's vocab-parallel lookup (its generic indexing would gather the
    whole table and batch), whose masked sum over the vocabulary shards is
    done at once: DTensor keeps its mask only for the lookup's own output.
    Any other table is indexed, as without a mesh (the two lookups'
    backwards sum a repeated token's gradients in different orders)."""
    if is_dtensor(table) and any(p.is_shard(0) for p in table.placements):
        return settle_grad(settle(F.embedding(ids, table)))
    return table[ids]


# ------------------------------------------------------------------ mlp ----
def gated_mlp(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
              wo: torch.Tensor, act=F.silu) -> torch.Tensor:
    h = constrain(act(x @ wi) * (x @ wg), "batch", None, "mlp")
    return h @ wo


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
        if is_dtensor(out):
            # a slice of a DTensor sharded on the sequence is no view, so
            # the shifted input is added out of place
            pad = torch.zeros_like(xf[:, :i])
            out = out + torch.cat([pad, xf[:, :s - i]], 1) * wf[:, k - 1 - i]
        else:
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

    A DTensor cache (on a mesh, the sequence sharded) takes the JAX
    package's masked select, copied into it in place: DTensor has no
    in-place row scatter into a sharded dim.
    """
    if is_dtensor(cache):
        slots = torch.arange(cache.shape[1], device=slot.device)
        hit = (slots[None, :] == slot[:, None])[:, :, None, None]
        return cache.copy_(torch.where(hit, new.to(cache.dtype), cache))
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot.long()] = new[:, 0].to(cache.dtype)
    return cache


def fill_cache(cache: torch.Tensor, stack: torch.Tensor,
               axes) -> torch.Tensor:
    """The (L,B,T,KH,D) cache with its first ``n = stack.shape[2]`` slots
    set to ``stack`` (in place), returned. On DTensors (on a mesh) the
    cache is built out of place, the stack followed by empty slots, and
    placed by the cache's logical ``axes``: DTensor cannot write into a
    slice of a sharded dim."""
    n = stack.shape[2]
    if not is_dtensor(stack):
        cache[:, :, :n] = stack
        return cache
    rest = cache[:, :, n:]
    return constrain(torch.cat([stack.to(cache.dtype), rest], dim=2), *axes)
