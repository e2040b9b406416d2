"""Mamba-2 SSD (state-space duality), the attention-free family, ported
from the JAX package's ``models/mamba2.py``.

The sequence is processed in chunks: with ``cfg.use_pallas`` the chunked
scan is the port's hand-written kernel (``kernels/ops.ssd_scan``: the CUDA
kernel on the card, its plain version on the CPU), which returns y in x's
dtype; otherwise ``ssd_chunked`` computes it in plain PyTorch ops and returns
f32. The two routes differ by that rounding in the JAX package too. Decode
carries an O(1) state (B, n_heads, headdim, d_state), no KV cache.

Parameters keep the stacked leading ``layers`` dimension of the JAX tree;
the layer stack is a Python loop over it where the JAX package runs
``lax.scan``. ``constrain`` calls are dropped (no device mesh on one card).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as nn
from repro_torch.models import transformer as tfm
from repro_torch.models.params import Spec, stack, tree_index
from repro_torch.sharding import constrain


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, di = cfg.d_model, cfg.d_inner
    g, n, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    k = cfg.ssm_conv_width
    return {
        "ln": Spec((d,), ("embed",), "zeros"),
        "wz": Spec((d, di), ("embed", "ssm_inner")),
        "wx": Spec((d, di), ("embed", "ssm_inner")),
        "wB": Spec((d, g * n), ("embed", None)),
        "wC": Spec((d, g * n), ("embed", None)),
        "wdt": Spec((d, nh), ("embed", "ssm_inner")),
        "conv_x": Spec((di, k), ("ssm_inner", None)),
        "conv_B": Spec((g * n, k), (None, None)),
        "conv_C": Spec((g * n, k), (None, None)),
        "A_log": Spec((nh,), ("ssm_inner",), "ssm_a"),
        "dt_bias": Spec((nh,), ("ssm_inner",), "ssm_dt"),
        "D": Spec((nh,), ("ssm_inner",), "ones"),
        "norm": Spec((di,), ("ssm_inner",), "zeros"),
        "wo": Spec((di, d), ("ssm_inner", "embed")),
    }


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    out = {
        "embed": Spec((cfg.vocab_size, d), ("vocab", "embed"), "normal", 0.7),
        "layers": stack(cfg.num_layers, layer_specs(cfg)),
        "final_norm": Spec((d,), ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = Spec((d, cfg.vocab_size), ("embed", "vocab"))
    return out


# ---------------------------------------------------------------------------
# SSD core (chunked, plain route)
# ---------------------------------------------------------------------------


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                return_final_state: bool = False):
    """SSD forward, every chunk at once, then the inter-chunk recurrence.

    x: (B,S,H,P); dt: (B,S,H) (post-softplus, f32); A: (H,) negative f32;
    Bm/Cm: (B,S,G,N). Heads are grouped: H = G * heads_per_group.
    Returns y: (B,S,H,P) f32 (and the final state (B,H,P,N) if asked).
    """
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc, q = s // chunk, chunk
    hpg = h // g

    xf = x.float().reshape(b, nc, q, h, p)
    dtc = dt.float().reshape(b, nc, q, h)
    Bc = Bm.float().reshape(b, nc, q, g, n)
    Cc = Cm.float().reshape(b, nc, q, g, n)

    cum = torch.cumsum(dtc * A[None, None, None, :], dim=2)   # (B,nc,Q,H)

    # ---- intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j ----
    # (the exponent is masked before exp, so it never overflows above the
    # diagonal; the JAX package masks exp's result, with the same values)
    mask = torch.ones(q, q, dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,Q,Q,H)
    L = torch.exp(torch.where(mask, diff, float("-inf")))
    cb = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)
    cb = cb.repeat_interleave(hpg, dim=-1)                    # (B,nc,Q,Q,H)
    w = cb * L * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xf)

    # ---- chunk states ----
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B,nc,Q,H)
    xdt = xf * (dtc * decay_to_end)[..., None]
    Bh = Bc.repeat_interleave(hpg, dim=3)                     # (B,nc,Q,H,N)
    states = torch.einsum("bcqhn,bcqhp->bchnp", Bh, xdt)      # (B,nc,H,N,P)

    # ---- inter-chunk recurrence (emits the state entering each chunk) ----
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)
    carry = torch.zeros(b, h, n, p, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (B,nc,H,N,P)

    # ---- inter-chunk output ----
    Ch = Cc.repeat_interleave(hpg, dim=3)                     # (B,nc,Q,H,N)
    y_off = torch.einsum("bcqhn,bchnp->bcqhp", Ch, prev_states)
    y_off = y_off * torch.exp(cum)[..., None]
    y = (y_intra + y_off).reshape(b, s, h, p)
    if return_final_state:
        return y, carry.transpose(-1, -2)                     # (B,H,P,N)
    return y


# ---------------------------------------------------------------------------
# Blocks / forward
# ---------------------------------------------------------------------------


def ssm_block(cfg: ModelConfig, p: Dict, x_in: torch.Tensor,
              collect_state: bool = False):
    b, s, _ = x_in.shape
    di, nh, pdim = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    kw = cfg.ssm_conv_width - 1
    h = nn.pre_norm(x_in, p["ln"])
    z = h @ p["wz"]
    x_pre, B_pre, C_pre = h @ p["wx"], h @ p["wB"], h @ p["wC"]
    x = F.silu(nn.causal_conv1d(x_pre, p["conv_x"]))
    Bm = F.silu(nn.causal_conv1d(B_pre, p["conv_B"]))
    Cm = F.silu(nn.causal_conv1d(C_pre, p["conv_C"]))
    dt = F.softplus((h @ p["wdt"]).float() + p["dt_bias"].float())
    x = constrain(x, "batch", None, "ssm_inner")
    # on a mesh the scan runs on each rank's batch rows and heads, the
    # sequence whole (the chunked scan splits it into chunks)
    dt = constrain(dt, "batch", None, "ssm_inner")
    Bm = constrain(Bm, "batch", None, None)
    Cm = constrain(Cm, "batch", None, None)
    A = -torch.exp(p["A_log"].float())
    # pad the sequence to a chunk multiple; dt=0 on padding makes it inert
    # (decay exp(0)=1, contribution dt*x=0), so states/outputs are exact
    s_pad = -(-s // cfg.ssm_chunk) * cfg.ssm_chunk
    if s_pad != s:
        x, Bm, Cm, dt = (F.pad(t, (0, 0, 0, s_pad - s))
                         for t in (x, Bm, Cm, dt))
    if cfg.use_pallas:
        y, final = kops.ssd_scan(
            shd.split_heads(x, nh, pdim), dt, A,
            shd.split_heads(Bm, g, n), shd.split_heads(Cm, g, n),
            chunk=min(cfg.ssm_chunk, s_pad))
    else:
        args = (shd.split_heads(x, nh, pdim), dt, A,
                shd.split_heads(Bm, g, n), shd.split_heads(Cm, g, n))
        if shd.is_dtensor(x):
            # on a mesh: each rank's batch rows and heads, as the kernel
            # route (the scan treats them independently)
            res = shd.local_shards(
                "ssd_chunked", lambda *a: ssd_chunked(
                    *a, cfg.ssm_chunk, return_final_state=collect_state),
                args, (("b", None, "h", None), ("b", None, "h"), ("h",),
                       ("b", None, "g", None), ("b", None, "g", None)),
                ({0: 0, 2: 2}, {0: 0, 2: 1})[:1 + collect_state])
        else:
            res = ssd_chunked(*args, cfg.ssm_chunk,
                              return_final_state=collect_state)
        y, final = res if collect_state else (res, None)
    y = y + (p["D"].float()[None, None, :, None]
             * shd.split_heads(x.float(), nh, pdim))
    y = y.reshape(b, s_pad, di)[:, :s].to(x_in.dtype)
    y = nn.rmsnorm(y * F.silu(z), p["norm"])
    out = x_in + nn.to_residual(cfg, y @ p["wo"])
    if collect_state:
        state = {"h": final,
                 "conv_x": x_pre[:, -kw:, :].float(),
                 "conv_B": B_pre[:, -kw:, :].float(),
                 "conv_C": C_pre[:, -kw:, :].float()}
        return out, state
    return out


def forward_hidden(cfg: ModelConfig, params: Dict, embeds: torch.Tensor, *,
                   remat: bool = False):
    """Run the layer stack. Returns (hidden, None, aux loss 0.0), as the JAX
    package's: the family has no kv. With ``remat`` each layer runs under
    ``transformer._remat``'s checkpointing."""
    seq_ax = "seq_sp" if cfg.seq_parallel else None

    def body(x, p):
        return constrain(ssm_block(cfg, p, x), "batch", seq_ax, "embed")

    fn = tfm._remat(cfg, body) if remat else body
    x = embeds
    for i in range(cfg.num_layers):
        x = fn(x, tree_index(params["layers"], i))
    return nn.rmsnorm(x, params["final_norm"]), None, 0.0


# ---------------------------------------------------------------------------
# Decode: O(1) state
# ---------------------------------------------------------------------------

CACHE_STATES = ("h", "conv_x", "conv_B", "conv_C")


def cache_specs(cfg: ModelConfig, batch_size: int,
                context_len: int) -> Dict[str, Any]:
    del context_len                                      # O(1) state
    l, b = cfg.num_layers, batch_size
    nh, pdim, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    kw = cfg.ssm_conv_width - 1
    gn = cfg.ssm_ngroups * n
    return {
        "h": Spec((l, b, nh, pdim, n),
                  ("layers", "batch", "ssm_inner", None, None), "zeros"),
        "conv_x": Spec((l, b, kw, cfg.d_inner),
                       ("layers", "batch", None, "ssm_inner"), "zeros"),
        "conv_B": Spec((l, b, kw, gn), ("layers", "batch", None, None),
                       "zeros"),
        "conv_C": Spec((l, b, kw, gn), ("layers", "batch", None, None),
                       "zeros"),
        "pos": Spec((b,), ("batch",), "zeros"),
    }


def init_cache(cfg: ModelConfig, batch_size: int, context_len: int,
               device: torch.device) -> Dict:
    """Every state leaf f32, as in the JAX package; ``pos`` int32."""
    tree = cache_specs(cfg, batch_size, context_len)
    cache = {k: torch.zeros(tree[k].shape, dtype=torch.float32,
                            device=device) for k in CACHE_STATES}
    cache["pos"] = torch.zeros(tree["pos"].shape, dtype=torch.int32,
                               device=device)
    return cache


def prefill(cfg: ModelConfig, params: Dict, batch: Dict,
            context_len: Optional[int] = None):
    """Prompt processing with exact decode-state handoff.

    As in the JAX package, ``batch["prompt_lens"]`` is not read: a
    right-padded prompt runs its pad tokens through the recurrence, the
    logits are those of the last (pad) position and ``pos`` is the padded
    length."""
    del context_len                                      # O(1) state
    tok = batch["tokens"]
    b, s = tok.shape
    x = nn.embed(params["embed"], tok)
    seq_ax = "seq_sp" if cfg.seq_parallel else None
    states = []
    for i in range(cfg.num_layers):
        x, st = ssm_block(cfg, tree_index(params["layers"], i), x,
                          collect_state=True)
        x = constrain(x, "batch", seq_ax, "embed")
        states.append(st)
    x = nn.rmsnorm(x, params["final_norm"])
    logits = tfm.logits_fn(cfg, params, x[:, -1:, :])
    cache = {k: torch.stack([st[k] for st in states]) for k in CACHE_STATES}
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=tok.device)
    return logits, cache


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, batch: Dict):
    """One token for every row. batch: {"token": (B,1)}.

    The state leaves of ``cache`` (all f32) are updated IN PLACE, one layer
    at a time, and returned in the new cache dict; ``pos`` is a new tensor.
    The JAX package builds a new state each step; at full width and batch 4
    that is 0.67 GB of ``h`` rewritten per token."""
    tok = batch["token"]
    x = nn.embed(params["embed"], tok)                   # (B,1,D)
    b = x.shape[0]
    di, nh, pdim = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    for i in range(cfg.num_layers):
        p = tree_index(params["layers"], i)
        hh = nn.rmsnorm(x, p["ln"])[:, 0, :]             # (B,D)
        z = hh @ p["wz"]
        xs, cx = nn.conv1d_step(hh @ p["wx"], cache["conv_x"][i],
                                p["conv_x"])
        Bs, cB = nn.conv1d_step(hh @ p["wB"], cache["conv_B"][i],
                                p["conv_B"])
        Cs, cC = nn.conv1d_step(hh @ p["wC"], cache["conv_C"][i],
                                p["conv_C"])
        xs, Bs, Cs = F.silu(xs), F.silu(Bs), F.silu(Cs)
        dt = F.softplus((hh @ p["wdt"]).float()
                        + p["dt_bias"].float())          # (B,H)
        A = -torch.exp(p["A_log"].float())
        xh = shd.split_heads(xs.float(), nh, pdim)
        Bh, Ch = (shd.split_heads(t.float(), g, n).repeat_interleave(
            nh // g, dim=1) for t in (Bs, Cs))
        decay = torch.exp(dt * A)                        # (B,H)
        hst = (cache["h"][i] * decay[:, :, None, None]
               + (dt[:, :, None] * xh)[..., None] * Bh[:, :, None, :])
        y = torch.einsum("bhpn,bhn->bhp", hst, Ch)
        y = y + p["D"].float()[None, :, None] * xh
        y = y.reshape(b, di).to(x.dtype)
        y = nn.rmsnorm(y * F.silu(z), p["norm"])
        x = x + (y @ p["wo"])[:, None, :]
        for key, new in (("h", hst), ("conv_x", cx), ("conv_B", cB),
                         ("conv_C", cC)):
            cache[key][i].copy_(new)
    x = nn.rmsnorm(x, params["final_norm"])
    logits = tfm.logits_fn(cfg, params, x)
    new_cache = dict(cache)
    new_cache["pos"] = cache["pos"] + 1
    return logits, new_cache
