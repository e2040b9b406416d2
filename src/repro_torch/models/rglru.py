"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local MQA
attention in a repeating (rec, rec, attn) pattern, each followed by a gated
MLP; ported from the JAX package's ``models/rglru.py``.

With ``cfg.use_pallas`` the recurrence h_t = a_t*h_{t-1} + b_t runs the
port's hand-written kernel (``kernels/ops.rglru_scan``: the CUDA kernel on
the card, its plain version on the CPU) and the local attention runs the
flash attention kernel (head_dim 256 at full width); otherwise the
recurrence is a log-depth parallel scan in plain PyTorch ops (the JAX
package's ``associative_scan``) and attention ``layers.chunked_attention``.
Decode keeps the O(1) recurrent state and a rolling local-window KV cache.

Layer stacking: the 3-block pattern repeats ``num_layers // 3`` times
(``supers``, a Python loop over the stacked parameters where the JAX
package runs ``lax.scan``); the remainder (38 % 3 = 2 recurrent blocks at
full width) is unrolled as ``tail0``, ``tail1``.

``jax.nn.gelu`` is the tanh approximation by default, so every GELU here is
``F.gelu(..., approximate="tanh")`` (PyTorch's default is exact erf).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as nn
from repro_torch.models import transformer as tfm
from repro_torch.models.params import Spec, stack, tree_index
from repro_torch.sharding import constrain, merge_heads

C_RGLRU = 8.0  # Griffin's fixed gate sharpness
_gelu = functools.partial(F.gelu, approximate="tanh")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _rec_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, w, h = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.n_heads
    bw = w // h                       # block width for block-diagonal gates
    return {
        "ln": Spec((d,), ("embed",), "zeros"),
        "wx": Spec((d, w), ("embed", "lru")),
        "wy": Spec((d, w), ("embed", "lru")),
        "conv_w": Spec((w, cfg.conv_width), ("lru", None)),
        "gate_a": Spec((h, bw, bw), ("heads", None, None)),
        "gate_a_b": Spec((w,), ("lru",), "zeros"),
        "gate_x": Spec((h, bw, bw), ("heads", None, None)),
        "gate_x_b": Spec((w,), ("lru",), "zeros"),
        "lam": Spec((w,), ("lru",), "lru_a"),
        "wo": Spec((w, d), ("lru", "embed")),
        "mlp_ln": Spec((d,), ("embed",), "zeros"),
        "mlp": tfm.mlp_specs(cfg),
    }


def _attn_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": Spec((cfg.d_model,), ("embed",), "zeros"),
        "attn": tfm.attn_specs(cfg),
        "ln2": Spec((cfg.d_model,), ("embed",), "zeros"),
        "mlp": tfm.mlp_specs(cfg),
    }


def _super_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"rec1": _rec_specs(cfg), "rec2": _rec_specs(cfg),
            "attn": _attn_specs(cfg)}


def n_super(cfg: ModelConfig) -> int:
    return cfg.num_layers // len(cfg.block_pattern)


def n_tail(cfg: ModelConfig) -> int:
    return cfg.num_layers % len(cfg.block_pattern)


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    out: Dict[str, Any] = {
        "embed": Spec((cfg.vocab_size, d), ("vocab", "embed"), "normal", 0.7),
        "supers": stack(n_super(cfg), _super_specs(cfg)),
        "final_norm": Spec((d,), ("embed",), "zeros"),
    }
    for i in range(n_tail(cfg)):
        out[f"tail{i}"] = _rec_specs(cfg)
    if not cfg.tie_embeddings:
        out["lm_head"] = Spec((d, cfg.vocab_size), ("embed", "vocab"))
    return out


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _block_diag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B,S,W); w: (H, W/H, W/H) block-diagonal projection."""
    b, s, width = x.shape
    h = w.shape[0]
    xr = x.reshape(b, s, h, width // h)
    return torch.einsum("bshw,hwv->bshv", xr, w).reshape(b, s, width)


def rglru_gates(p: Dict, bx: torch.Tensor):
    """Compute (a, b) of h_t = a*h + b from the conv branch activation."""
    r = torch.sigmoid(_block_diag(bx, p["gate_a"]).float()
                      + p["gate_a_b"].float())
    i = torch.sigmoid(_block_diag(bx, p["gate_x"]).float()
                      + p["gate_x_b"].float())
    log_a = -C_RGLRU * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = (torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
         * (i * bx.float()))
    return a, b


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               use_pallas: bool = False) -> torch.Tensor:
    """Linear recurrence h_t = a_t*h_{t-1} + b_t along axis 1."""
    if use_pallas:
        # on a mesh the kernel runs on each rank's batch rows and columns
        a = constrain(a, "batch", None, "lru")
        b = constrain(b, "batch", None, "lru")
        s, w = a.shape[1], a.shape[2]
        return kops.rglru_scan(a, b, chunk=min(64, s),
                               width_block=min(128, w))
    # log-depth inclusive scan with the combine (a1, b1), (a2, b2) ->
    # (a1*a2, b1*a2 + b2), as the JAX package's associative_scan
    s, off = a.shape[1], 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return b


def _rec_with_state(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                    lru_constrain: bool = False):
    """A recurrent block, returning its decode state too (the JAX package's
    ``rec_with_state``, the duplicate of ``rec_block`` inside
    ``forward_hidden``). ``rec_block`` also constrains the conv output to
    the "lru" axis, as the JAX package's does."""
    kw = cfg.conv_width - 1
    h = nn.pre_norm(x, p["ln"])
    bx_pre = h @ p["wx"]
    by = _gelu(h @ p["wy"])
    bx = nn.causal_conv1d(bx_pre, p["conv_w"])
    if lru_constrain:
        bx = constrain(bx, "batch", None, "lru")
    a, bb = rglru_gates(p, bx)
    hs = rglru_scan(a, bb, cfg.use_pallas)
    x = x + nn.to_residual(cfg, (hs.to(x.dtype) * by) @ p["wo"])
    h2 = nn.pre_norm(x, p["mlp_ln"])
    x = x + nn.to_residual(cfg, nn.gated_mlp(h2, act=_gelu, **p["mlp"]))
    return x, {"h": hs[:, -1, :], "conv": bx_pre[:, -kw:, :]}


def rec_block(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    return _rec_with_state(cfg, p, x, lru_constrain=True)[0]


def _local_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg.replace(sliding_window=cfg.local_window, qk_norm=False)


def attn_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, Tuple]:
    x, kv = tfm.attn_block(_local_cfg(cfg), p, x, positions)
    h2 = nn.pre_norm(x, p["ln2"])
    return x + nn.to_residual(cfg, nn.gated_mlp(h2, act=_gelu, **p["mlp"])), kv


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _stack_states(states):
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def forward_hidden(cfg: ModelConfig, params: Dict, embeds: torch.Tensor, *,
                   collect_state: bool = False, remat: bool = False):
    """Returns (hidden, (super states, tail states) | None, aux loss 0.0),
    as the JAX package's. Super states are {"rec1": {"h", "conv"}, "rec2":
    ..., "kv": (k, v)}, each stacked over the supers. With ``remat`` each
    super-block runs under ``transformer._remat``'s checkpointing (the tail
    blocks do not, as in the JAX package)."""
    s = embeds.shape[1]
    positions = torch.arange(s, device=embeds.device)

    def body(x, p):
        x, st1 = _rec_with_state(cfg, p["rec1"], x)
        x, st2 = _rec_with_state(cfg, p["rec2"], x)
        x, kv = attn_block(cfg, p["attn"], x, positions)
        x = constrain(x, "batch", "seq_sp" if cfg.seq_parallel else None,
                      "embed")
        return x, st1, st2, kv

    fn = tfm._remat(cfg, body) if remat else body
    x = embeds
    rec1, rec2, ks, vs = [], [], [], []
    for i in range(n_super(cfg)):
        x, st1, st2, (k, v) = fn(x, tree_index(params["supers"], i))
        if collect_state:
            rec1.append(st1)
            rec2.append(st2)
            ks.append(k)
            vs.append(v)
    tail_states = {}
    for i in range(n_tail(cfg)):
        x, tail_states[f"tail{i}"] = _rec_with_state(cfg,
                                                     params[f"tail{i}"], x)
    x = nn.rmsnorm(x, params["final_norm"])
    if not collect_state:
        return x, None, 0.0
    states = {"rec1": _stack_states(rec1), "rec2": _stack_states(rec2),
              "kv": (torch.stack(ks), torch.stack(vs))}
    return x, (states, tail_states), 0.0


def prefill(cfg: ModelConfig, params: Dict, batch: Dict,
            context_len: Optional[int] = None):
    """Prompt processing with exact state handoff (LRU h, conv tail, KV).

    As in the JAX package, ``batch["prompt_lens"]`` is not read: a
    right-padded prompt runs its pad tokens through the recurrence and the
    attention, the logits are those of the last (pad) position and ``pos``
    is the padded length."""
    tok = batch["tokens"]
    b, s = tok.shape
    context_len = context_len if context_len is not None else s
    x, (states, tail_states), _ = forward_hidden(
        cfg, params, nn.embed(params["embed"], tok), collect_state=True)
    logits = tfm.logits_fn(cfg, params, x[:, -1:, :])
    cache = init_cache(cfg, b, context_len, device=tok.device)
    cap = cache["k"].shape[2]
    keep = min(s, cap)
    for r in ("rec1", "rec2"):
        cache[r]["h"] = states[r]["h"]
        cache[r]["conv"] = states[r]["conv"].to(torch.bfloat16)
    k_stack, v_stack = states["kv"]             # (NS,B,S,KH,Dh)
    axes = cache_specs(cfg, b, context_len)["k"].axes
    for key, st in (("k", k_stack), ("v", v_stack)):
        cache[key] = nn.fill_cache(cache[key], st[:, :, s - keep:], axes)
    cache["k_pos"][:, :keep] = torch.arange(s - keep, s, dtype=torch.int32,
                                            device=tok.device)[None, :]
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=tok.device)
    for name, st in tail_states.items():
        cache[name]["h"] = st["h"]
        cache[name]["conv"] = st["conv"].to(torch.bfloat16)
    return logits, cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch_size: int,
                context_len: int) -> Dict[str, Any]:
    w = cfg.lru_width or cfg.d_model
    kw = cfg.conv_width - 1
    cap = min(cfg.local_window, context_len + 128)
    ns = n_super(cfg)
    rec = {
        "h": Spec((ns, batch_size, w), ("layers", "batch", "lru"), "zeros"),
        "conv": Spec((ns, batch_size, kw, w),
                     ("layers", "batch", None, "lru"), "zeros"),
    }
    kvs = Spec((ns, batch_size, cap, cfg.n_kv_heads, cfg.head_dim),
               ("layers", "batch", None, None, None), "zeros")
    out: Dict[str, Any] = {
        "rec1": dict(rec), "rec2": dict(rec),
        "k": kvs, "v": kvs,
        "k_pos": Spec((batch_size, cap), ("batch", None), "zeros"),
        "pos": Spec((batch_size,), ("batch",), "zeros"),
    }
    for i in range(n_tail(cfg)):
        out[f"tail{i}"] = {
            "h": Spec((batch_size, w), ("batch", "lru"), "zeros"),
            "conv": Spec((batch_size, kw, w), ("batch", None, "lru"),
                         "zeros"),
        }
    return out


def init_cache(cfg: ModelConfig, batch_size: int, context_len: int,
               device: torch.device) -> Dict:
    """bf16 zeros, as in the JAX package, but the recurrent states ``h`` in
    f32; ``k_pos = -1`` marks an empty slot; ``pos`` int32."""
    tree = cache_specs(cfg, batch_size, context_len)

    def zeros(spec, dtype=torch.bfloat16):
        return torch.zeros(spec.shape, dtype=dtype, device=device)

    cache: Dict[str, Any] = {"k": zeros(tree["k"]), "v": zeros(tree["v"]),
                             "k_pos": torch.full(tree["k_pos"].shape, -1,
                                                 dtype=torch.int32,
                                                 device=device),
                             "pos": zeros(tree["pos"], torch.int32)}
    for key in ["rec1", "rec2"] + [f"tail{i}" for i in range(n_tail(cfg))]:
        cache[key] = {"h": zeros(tree[key]["h"], torch.float32),
                      "conv": zeros(tree[key]["conv"])}
    return cache


def _rec_step(cfg: ModelConfig, p: Dict, x: torch.Tensor, st: Dict):
    """x: (B,1,D). One-token recurrent block."""
    h = nn.rmsnorm(x, p["ln"])
    bx_pre = (h @ p["wx"])[:, 0, :]                       # (B,W)
    by = _gelu(h @ p["wy"])[:, 0, :]
    bx, conv_buf = nn.conv1d_step(bx_pre, st["conv"], p["conv_w"])
    a, bb = rglru_gates(p, bx[:, None, :])
    h_new = a[:, 0] * st["h"] + bb[:, 0]
    x = x + ((h_new.to(x.dtype) * by) @ p["wo"])[:, None, :]
    h2 = nn.rmsnorm(x, p["mlp_ln"])
    x = x + nn.gated_mlp(h2, act=_gelu, **p["mlp"])
    return x, {"h": h_new, "conv": conv_buf}


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, batch: Dict):
    """One token for every row. batch: {"token": (B,1)}. The local window's
    k/v cache is a ring: position ``pos`` goes to slot ``pos % cap``.

    The k/v tensors of ``cache`` are updated IN PLACE (one row written per
    super-block); the recurrent states, ``k_pos`` and ``pos`` are new
    tensors (a state's dtype may change, as in the JAX package: an f32
    conv input promotes the bf16 conv buffer to f32)."""
    tok = batch["token"]
    x = nn.embed(params["embed"], tok)
    pos = cache["pos"]                                   # (B,)
    positions = pos[:, None]
    cap = cache["k"].shape[2]
    slot = pos % cap
    slots = torch.arange(cache["k_pos"].shape[1], device=pos.device)
    k_pos = torch.where(slots[None, :] == slot[:, None], pos[:, None],
                        cache["k_pos"])
    acfg = _local_cfg(cfg)
    rec1, rec2 = [], []
    for i in range(n_super(cfg)):
        p = tree_index(params["supers"], i)
        x, st1 = _rec_step(cfg, p["rec1"], x, tree_index(cache["rec1"], i))
        x, st2 = _rec_step(cfg, p["rec2"], x, tree_index(cache["rec2"], i))
        rec1.append(st1)
        rec2.append(st2)
        pa = p["attn"]
        h = nn.rmsnorm(x, pa["ln1"])
        q, k, v = tfm._project_qkv(acfg, pa["attn"], h, positions)
        kc = nn.masked_cache_update(cache["k"][i], k, slot)
        vc = nn.masked_cache_update(cache["v"][i], v, slot)
        ctx = nn.attend(q, kc, vc, positions, k_pos, causal=True,
                        window=cfg.local_window)
        x = x + tfm._matmul(merge_heads(ctx), pa["attn"]["wo"])
        h2 = nn.rmsnorm(x, pa["ln2"])
        x = x + nn.gated_mlp(h2, act=_gelu, **pa["mlp"])
    new_cache = dict(cache)
    new_cache.update(rec1=_stack_states(rec1), rec2=_stack_states(rec2),
                     k_pos=k_pos, pos=pos + 1)
    for i in range(n_tail(cfg)):
        x, new_cache[f"tail{i}"] = _rec_step(cfg, params[f"tail{i}"], x,
                                             cache[f"tail{i}"])
    x = nn.rmsnorm(x, params["final_norm"])
    logits = tfm.logits_fn(cfg, params, x)
    return logits, new_cache
