"""Decoder-only transformer families: dense (qwen3 / yi / llama3), MoE
(mixtral / dbrx) and VLM (the phi-3-vision backbone, whose image frontend is
a stub: precomputed image embeddings go in front of the token embeddings),
ported from the JAX package's ``models/transformer.py``.

Parameters keep the stacked leading ``layers`` dimension of the JAX tree; the
layer stack is a Python loop over it where the JAX package runs
``lax.scan``. Decode uses either a full-length KV cache or a rolling window
buffer (sliding-window archs), both position-mask based. With
``cfg.use_pallas`` prefill attention runs the port's hand-written flash
attention kernel (``kernels/ops.flash_attention``); otherwise it runs
``layers.chunked_attention``. Decode attention is ``layers.attend`` either
way, as in the JAX package. The MoE family's feed-forward is
``moe.moe_block``; its load-balancing loss is summed by ``forward_hidden``
and ignored by ``prefill`` and ``decode_step``. Each layer's decode
attention and MoE block are profiler ranges (``decode.attend``,
``layer.moe``; ``repro_torch.ranges``).

On a device mesh (``sharding.use_mesh``) the tensors are DTensors and
``constrain`` places the activations where the JAX package does. With
``decode_impl="shmap_flash"`` decode runs ``_flash_decode_shmap``, the split-K
flash decode over the sequence-sharded cache, under the JAX package's
conditions.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import MOE, VLM, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as nn
from repro_torch.models import moe as moe_mod
from repro_torch.models.params import Spec, stack, tree_index
from repro_torch import sharding as shd
from repro_torch.ranges import ranged
from repro_torch.sharding import constrain, merge_heads, split_heads


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    out: Dict[str, Any] = {
        "wq": Spec((d, cfg.q_dim), ("embed", "heads")),
        "wk": Spec((d, cfg.kv_dim), ("embed", "kv")),
        "wv": Spec((d, cfg.kv_dim), ("embed", "kv")),
        "wo": Spec((cfg.q_dim, d), ("heads", "embed")),
    }
    if cfg.qk_norm:
        out["q_norm"] = Spec((cfg.head_dim,), (None,), "zeros")
        out["k_norm"] = Spec((cfg.head_dim,), (None,), "zeros")
    return out


def mlp_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": Spec((d, f), ("embed", "mlp")),
        "wg": Spec((d, f), ("embed", "mlp")),
        "wo": Spec((f, d), ("mlp", "embed")),
    }


def layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    out = {
        "ln1": Spec((cfg.d_model,), ("embed",), "zeros"),
        "ln2": Spec((cfg.d_model,), ("embed",), "zeros"),
        "attn": attn_specs(cfg),
    }
    if cfg.family == MOE:
        out["moe"] = moe_mod.moe_specs(cfg)
    else:
        out["mlp"] = mlp_specs(cfg)
    return out


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
# Blocks
# ---------------------------------------------------------------------------


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's type promotion (a bf16 context times f32 weights
    is an f32 product there; PyTorch refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _project_qkv(cfg: ModelConfig, p: Dict, h: torch.Tensor,
                 positions: torch.Tensor):
    q = split_heads(h @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = split_heads(h @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = split_heads(h @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = nn.qk_norm(q, p["q_norm"])
        k = nn.qk_norm(k, p["k_norm"])
    q = nn.apply_rope(q, positions, cfg.rope_theta)
    k = nn.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, Tuple]:
    """Self-attention over the in-context sequence (prefill)."""
    h = nn.pre_norm(x, p["ln1"])
    q, k, v = _project_qkv(cfg, p["attn"], h, positions)
    q = constrain(q, "batch", None, "heads", None)
    if cfg.use_pallas:
        # on a mesh the kernel runs on each rank's batch rows and heads
        k = constrain(k, "batch", None, "heads", None)
        v = constrain(v, "batch", None, "heads", None)
        blk = min(128, q.shape[1])
        ctx = kops.flash_attention(q, k, v, causal=cfg.causal,
                                   window=cfg.sliding_window,
                                   q_block=blk, kv_block=blk)
    else:
        ctx = nn.chunked_attention(q, k, v, causal=cfg.causal,
                                   window=cfg.sliding_window,
                                   q_chunk=cfg.attn_q_chunk)
    out = _matmul(merge_heads(ctx), p["attn"]["wo"])
    return x + nn.to_residual(cfg, out), (k, v)


def ffn_block(cfg: ModelConfig, p: Dict, x: torch.Tensor):
    """Returns (x + ffn(x), aux loss): the MoE block's load-balancing loss,
    or 0.0 (a Python float: no launch on the card) for the dense MLP."""
    h = nn.pre_norm(x, p["ln2"])
    if cfg.family == MOE:
        with ranged("layer.moe"):
            out, aux = moe_mod.moe_block(cfg, p["moe"], h)
    else:
        out, aux = nn.gated_mlp(h, **p["mlp"]), 0.0
    return x + nn.to_residual(cfg, out), aux


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``remat="dots"``: keep the
    outputs of the unbatched products (``jax.checkpoint_policies.
    checkpoint_dots_with_no_batch_dims``), recompute everything else, the
    attention's batched products among it."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """One layer under activation checkpointing, by ``cfg.remat``: "none"
    runs ``fn`` as it is, "full" saves nothing of it, "dots" saves the
    outputs of its unbatched products. The values are those of ``fn``."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    return functools.partial(
        ckpt.checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                     _save_dots))


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def embed_inputs(cfg: ModelConfig, params: Dict, batch: Dict) -> torch.Tensor:
    tok = nn.embed(params["embed"], batch["tokens"])
    if cfg.family == VLM:
        img = batch["image_embeds"].to(tok.dtype)          # (B, Nimg, D)
        tok = torch.cat([img, tok], dim=1)
    return constrain(tok, "batch", None, "embed")


def forward_hidden(cfg: ModelConfig, params: Dict, embeds: torch.Tensor, *,
                   collect_kv: bool = False, remat: bool = False):
    """Run the layer stack. Returns (hidden, (k_stack, v_stack) | None,
    aux_loss), the stacks (L,B,S,KH,Dh), the aux loss the sum of the MoE
    layers' (an f32 scalar tensor; 0.0 for the other families). With
    ``remat`` each layer runs under ``_remat``'s checkpointing."""
    s = embeds.shape[1]
    positions = torch.arange(s, device=embeds.device)

    def body(x, p):
        x, kv = attn_block(cfg, p, x, positions)
        x, a = ffn_block(cfg, p, x)
        seq_ax = "seq_sp" if cfg.seq_parallel else None
        return constrain(x, "batch", seq_ax, "embed"), kv, a

    fn = _remat(cfg, body) if remat else body
    x, ks, vs = embeds, [], []
    aux = 0.0
    for i in range(cfg.num_layers):
        x, (k, v), a = fn(x, tree_index(params["layers"], i))
        aux = aux + a
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = nn.rmsnorm(x, params["final_norm"])
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, kvs, aux


def logits_fn(cfg: ModelConfig, params: Dict, h: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    h = constrain(h, "batch", None, "embed")         # the sequence whole
    return constrain(h @ head, "batch", None, "vocab")


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------


def cache_capacity(cfg: ModelConfig, context_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, context_len + 128)
    return context_len + 128


def cache_specs(cfg: ModelConfig, batch_size: int,
                context_len: int) -> Dict[str, Any]:
    """Declarative cache layout. ``pos`` is PER ROW (B,), which is what lets
    the serving engine run continuous batching (each slot at its own decode
    position)."""
    cap = cache_capacity(cfg, context_len)
    seq_ax = "kv_seq" if cfg.decode_seq_shard else None
    kv = Spec((cfg.num_layers, batch_size, cap, cfg.n_kv_heads, cfg.head_dim),
              ("layers", "batch", seq_ax, None, None), "zeros")
    return {
        "k": kv,
        "v": kv,
        "k_pos": Spec((batch_size, cap), ("batch", None), "zeros"),
        "pos": Spec((batch_size,), ("batch",), "zeros"),
    }


def init_cache(cfg: ModelConfig, batch_size: int, context_len: int,
               device: torch.device) -> Dict:
    """k/v in bf16 whatever the parameters' dtype, as in the JAX package;
    ``k_pos = -1`` marks an empty slot."""
    tree = cache_specs(cfg, batch_size, context_len)
    return {
        "k": torch.zeros(tree["k"].shape, dtype=torch.bfloat16,
                         device=device),
        "v": torch.zeros(tree["v"].shape, dtype=torch.bfloat16,
                         device=device),
        "k_pos": torch.full(tree["k_pos"].shape, -1, dtype=torch.int32,
                            device=device),
        "pos": torch.zeros(tree["pos"].shape, dtype=torch.int32,
                           device=device),
    }


def pack_cache(stack: torch.Tensor, lens: torch.Tensor,
               cap: int) -> torch.Tensor:
    """Per-row gather of the last min(len_i, cap) entries of a (B,S,KH,D)
    kv stack into a (B,cap,KH,D) cache, right-padded prompts supported. A
    layer-stacked (L,B,S,KH,D) stack gathers every layer at once (the JAX
    package vmaps over layers)."""
    lead = stack.ndim - 4                      # 0, or 1 with layers first
    b, s = stack.shape[lead], stack.shape[lead + 1]
    start = torch.clamp(lens.long() - cap, min=0)                 # (B,)
    idx = start[:, None] + torch.arange(cap, device=stack.device)[None, :]
    idx = torch.clamp(idx, max=s - 1)                             # (B,cap)
    rows = torch.arange(b, device=stack.device)[:, None]
    return stack[rows, idx] if lead == 0 else stack[:, rows, idx]


def prefill(cfg: ModelConfig, params: Dict, batch: Dict,
            context_len: Optional[int] = None):
    """Process the prompt; return (last-token logits, populated cache).

    ``batch["prompt_lens"]`` (B,) optionally marks right-padded prompts;
    defaults to the full sequence length for every row.
    """
    embeds = embed_inputs(cfg, params, batch)
    b, s, _ = embeds.shape
    dev = embeds.device
    context_len = context_len if context_len is not None else s
    raw_lens = batch.get("prompt_lens")
    lens = (torch.full((b,), s, dtype=torch.int32, device=dev)
            if raw_lens is None else raw_lens.to(device=dev,
                                                 dtype=torch.int32))
    h, (k_stack, v_stack), _ = forward_hidden(cfg, params, embeds,
                                              collect_kv=True)
    cache = init_cache(cfg, b, context_len, device=dev)
    cap = cache["k"].shape[2]
    if raw_lens is None:
        # uniform prompt lengths: static slices into the bf16 cache
        logits = logits_fn(cfg, params, h[:, -1:, :])
        keep = min(s, cap)
        axes = cache_specs(cfg, b, context_len)["k"].axes
        for key, st in (("k", k_stack), ("v", v_stack)):
            cache[key] = nn.fill_cache(cache[key], st[:, :, s - keep:], axes)
        pos = torch.arange(s - keep, s, dtype=torch.int32, device=dev)
        cache["k_pos"][:, :keep] = pos[None, :]
    else:
        # ragged prompts (serving engine): per-row gather; the cache takes
        # the stack's dtype, as in the JAX package
        last = h[torch.arange(b, device=dev), lens.long() - 1][:, None, :]
        logits = logits_fn(cfg, params, last)
        cache["k"] = pack_cache(k_stack, lens, cap)
        cache["v"] = pack_cache(v_stack, lens, cap)
        start = torch.clamp(lens - cap, min=0)
        k_pos = start[:, None] + torch.arange(cap, device=dev)[None, :]
        cache["k_pos"] = torch.where(k_pos < lens[:, None], k_pos,
                                     -1).to(torch.int32)
    cache["pos"] = lens
    return logits, cache


# ---------------------------------------------------------------------------
# Split-K flash decode over the sequence-sharded cache (the JAX package's
# shard_map body). Each "model" rank owns one slice of the cache: the token
# write is a local per-row write into that slice, attention reduces the slice
# with online-softmax partials, and a MAX and two SUM all-reduces over
# "model" combine them (the split-K pattern of the decode kernel lifted to
# the mesh, in plain torch products as the reference's einsums).
# ---------------------------------------------------------------------------


def _flash_decode_shmap(q, kc, vc, k_new, v_new, slot, pos, mesh):
    """q: (B,1,H,Dh); kc/vc: (B,T,KH,Dh) seq-sharded over "model";
    k_new/v_new: (B,1,KH,Dh); slot/pos: (B,). Returns (ctx, kc, vc); the
    rank's cache slice is written IN PLACE.

    Only used for full (non-rolling) caches, where slot index == position.
    """
    dp = shd.dp_axes(mesh)
    h, dh = q.shape[2], q.shape[3]
    kh = kc.shape[2]
    g = h // kh
    scale = dh ** -0.5

    def local(q, kc, vc, k_new, v_new, slot, pos):
        b_loc, t_loc = kc.shape[0], kc.shape[1]
        off = shd.axis_index("model") * t_loc
        rows = torch.arange(b_loc, device=kc.device)
        slot_loc = slot.long() - off
        own = (slot_loc >= 0) & (slot_loc < t_loc)
        idx = torch.clamp(slot_loc, 0, t_loc - 1)
        for c, new in ((kc, k_new), (vc, v_new)):
            c[rows, idx] = torch.where(own[:, None, None],
                                       new[:, 0].to(c.dtype), c[rows, idx])
        j = off + torch.arange(t_loc, device=kc.device)[None, :]
        valid = j <= pos[:, None]                             # (B,T_loc)
        qr = q.reshape(b_loc, kh, g, dh)
        s = torch.einsum("bkgd,btkd->bkgt", qr.float(), kc.float()) * scale
        s = torch.where(valid[:, None, None, :], s, -1e30)
        m = s.amax(dim=-1, keepdim=True)                      # (B,KH,G,1)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bkgt,btkd->bkgd", p.to(vc.dtype), vc)
        m_g = shd.pmax(m, "model")
        w = torch.exp(m - m_g)
        l_g = shd.psum(l * w, "model")
        acc_g = shd.psum(acc.float() * w, "model")
        out = acc_g / torch.clamp(l_g, min=1e-30)
        return out.reshape(b_loc, 1, h, dh).to(q.dtype), kc, vc

    row = (dp, None, None, None)
    seq = (dp, "model", None, None)
    return shd.shard_map(
        local, mesh, in_specs=(row, seq, seq, row, row, (dp,), (dp,)),
        out_specs=[row, seq, seq])(q, kc, vc, k_new, v_new, slot, pos)


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, batch: Dict):
    """One token for every row. batch: {"token": (B,1)}. Rows may sit at
    different positions (continuous batching).

    The k/v tensors of ``cache`` are updated IN PLACE (one row written per
    layer) and returned in the new cache dict; ``k_pos``/``pos`` are new
    tensors.
    """
    tok = batch["token"]
    x = nn.embed(params["embed"], tok)                   # (B,1,D)
    pos = cache["pos"]                                   # (B,)
    positions = pos[:, None]
    cap = cache["k"].shape[2]
    slot = pos % cap                                     # (B,)
    slots = torch.arange(cache["k_pos"].shape[1], device=pos.device)
    k_pos = torch.where(slots[None, :] == slot[:, None], pos[:, None],
                        cache["k_pos"])
    mesh = shd.current_mesh()
    use_shmap = (cfg.decode_impl == "shmap_flash" and mesh is not None
                 and "model" in shd.axis_names(mesh)
                 and cfg.sliding_window is None and cfg.decode_seq_shard
                 and cap % shd.mesh_shape(mesh)["model"] == 0)
    for i in range(cfg.num_layers):
        p = tree_index(params["layers"], i)
        h = nn.rmsnorm(x, p["ln1"])
        q, k, v = _project_qkv(cfg, p["attn"], h, positions)
        with ranged("decode.attend"):
            if use_shmap:
                ctx, _, _ = _flash_decode_shmap(q, cache["k"][i],
                                                cache["v"][i], k, v, slot,
                                                pos, mesh)
            else:
                kc = nn.masked_cache_update(cache["k"][i], k, slot)
                vc = nn.masked_cache_update(cache["v"][i], v, slot)
                ctx = nn.attend(q, kc, vc, positions, k_pos, causal=True,
                                window=cfg.sliding_window)
        x = x + _matmul(merge_heads(ctx), p["attn"]["wo"])
        x, _ = ffn_block(cfg, p, x)
    x = nn.rmsnorm(x, params["final_norm"])
    logits = logits_fn(cfg, params, x)
    new_cache = dict(cache)
    new_cache["k_pos"] = k_pos
    new_cache["pos"] = pos + 1
    return logits, new_cache
