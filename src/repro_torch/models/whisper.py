"""Whisper-small backbone, ported from the JAX package's ``models/whisper.py``:
a transformer encoder over precomputed audio frame embeddings (the conv
frontend is a stub: the caller supplies (B, n_enc_frames, d_model) frames)
and a causal decoder with cross-attention.

As in the JAX package, the decoder uses RoPE instead of Whisper's learned
absolute positions, and the encoder keeps learned positions over its fixed
frames. Attention is ``layers.attend`` everywhere (no kernel route, as
there). ``jax.nn.gelu`` is the tanh approximation by default, so the MLP's
GELU is ``F.gelu(..., approximate="tanh")``.

Layer stacks are Python loops over the stacked parameters where the JAX
package runs ``lax.scan``. A decode step writes its k/v row into the cache IN
PLACE (``layers.masked_cache_update``). The decode slot is the position
itself: the self-attention cache never wraps. The cross-attention caches
``xk``/``xv`` are filled once, at prefill.

Products go through ``transformer._matmul`` (JAX's type promotion): the
encoder's input is bf16 whatever the parameters' dtype, as in the JAX
package, and PyTorch refuses a bf16 x f32 product.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as nn
from repro_torch.models import transformer as tfm
from repro_torch.models.params import Spec, stack, tree_index
from repro_torch.sharding import constrain, merge_heads, split_heads

_gelu = functools.partial(F.gelu, approximate="tanh")
_matmul = tfm._matmul


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _mlp2_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    return {"wi": Spec((d, f), ("embed", "mlp")),
            "wo": Spec((f, d), ("mlp", "embed"))}


def _enc_layer(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": Spec((cfg.d_model,), ("embed",), "zeros"),
            "attn": tfm.attn_specs(cfg),
            "ln2": Spec((cfg.d_model,), ("embed",), "zeros"),
            "mlp": _mlp2_specs(cfg)}


def _dec_layer(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": Spec((cfg.d_model,), ("embed",), "zeros"),
            "self_attn": tfm.attn_specs(cfg),
            "ln_x": Spec((cfg.d_model,), ("embed",), "zeros"),
            "cross_attn": tfm.attn_specs(cfg),
            "ln2": Spec((cfg.d_model,), ("embed",), "zeros"),
            "mlp": _mlp2_specs(cfg)}


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "enc_pos": Spec((cfg.n_enc_frames, d), ("frames", "embed"), "pos"),
        "enc_layers": stack(cfg.n_enc_layers, _enc_layer(cfg)),
        "enc_norm": Spec((d,), ("embed",), "zeros"),
        "embed": Spec((cfg.vocab_size, d), ("vocab", "embed"), "normal", 0.7),
        "dec_layers": stack(cfg.num_layers, _dec_layer(cfg)),
        "final_norm": Spec((d,), ("embed",), "zeros"),
        "lm_head": Spec((d, cfg.vocab_size), ("embed", "vocab")),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _res(y: torch.Tensor) -> torch.Tensor:
    """A block's output in the residual stream's placement (batch-sharded,
    as the JAX package constrains the stream): on a mesh the row-parallel
    product's partial sums are reduced here, so that DTensor does not pick
    a sequence shard for the stream by itself. Identity in value."""
    return constrain(y, "batch", None, "embed")


def _mlp2(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return _matmul(_gelu(_matmul(x, p["wi"])), p["wo"])


def _attn(cfg: ModelConfig, p: Dict, xq: torch.Tensor, xkv: torch.Tensor,
          q_pos, k_pos, causal: bool, rope: bool):
    q = split_heads(_matmul(xq, p["wq"]), cfg.n_heads, cfg.head_dim)
    k = split_heads(_matmul(xkv, p["wk"]), cfg.n_kv_heads, cfg.head_dim)
    v = split_heads(_matmul(xkv, p["wv"]), cfg.n_kv_heads, cfg.head_dim)
    if rope:
        q = nn.apply_rope(q, q_pos, cfg.rope_theta)
        k = nn.apply_rope(k, k_pos, cfg.rope_theta)
    ctx = nn.attend(q, k, v, q_pos, k_pos, causal=causal)
    return _matmul(merge_heads(ctx), p["wo"]), (k, v)


def encode(cfg: ModelConfig, params: Dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: (B, F, D) precomputed embeddings (stub frontend)."""
    x = frames.to(torch.bfloat16) + params["enc_pos"][None].to(torch.bfloat16)
    x = constrain(x, "batch", None, "embed")
    pos = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_enc_layers):
        p = tree_index(params["enc_layers"], i)
        h = nn.rmsnorm(x, p["ln1"])
        out, _ = _attn(cfg, p["attn"], h, h, pos, pos, causal=False,
                       rope=False)
        x = x + _res(out)
        h2 = nn.rmsnorm(x, p["ln2"])
        x = x + _res(_mlp2(p["mlp"], h2))
    return nn.rmsnorm(x, params["enc_norm"])


def _dec_layer_fwd(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                   enc_out: torch.Tensor, pos, fpos):
    """One decoder layer over the whole sequence; returns (x, self-attn
    (k, v), cross-attn (k, v))."""
    h = nn.rmsnorm(x, p["ln1"])
    out, kv = _attn(cfg, p["self_attn"], h, h, pos, pos, causal=True,
                    rope=True)
    x = x + _res(out)
    hx = nn.rmsnorm(x, p["ln_x"])
    out, xkv = _attn(cfg, p["cross_attn"], hx, enc_out, pos, fpos,
                     causal=False, rope=False)
    x = x + _res(out)
    h2 = nn.rmsnorm(x, p["ln2"])
    return x + _res(_mlp2(p["mlp"], h2)), kv, xkv


def decode_train(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                 enc_out: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """Teacher-forced decoder logits (B, S, vocab) over ``tokens``. With
    ``remat`` each decoder layer runs under ``transformer._remat``'s
    checkpointing (the encoder does not, as in the JAX package)."""
    x = constrain(nn.embed(params["embed"], tokens), "batch", None,
                  "embed")
    dev = x.device
    pos = torch.arange(tokens.shape[1], device=dev)
    fpos = torch.arange(enc_out.shape[1], device=dev)

    def body(x, p):
        return _dec_layer_fwd(cfg, p, x, enc_out, pos, fpos)[0]

    fn = tfm._remat(cfg, body) if remat else body
    for i in range(cfg.num_layers):
        x = fn(x, tree_index(params["dec_layers"], i))
    x = nn.rmsnorm(x, params["final_norm"])
    return _matmul(x, params["lm_head"])


# ---------------------------------------------------------------------------
# Decode with caches
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch_size: int,
                context_len: int) -> Dict[str, Any]:
    cap = context_len + 128
    l, b = cfg.num_layers, batch_size
    kv = Spec((l, b, cap, cfg.n_kv_heads, cfg.head_dim),
              ("layers", "batch", "kv_seq", None, None), "zeros")
    xkv = Spec((l, b, cfg.n_enc_frames, cfg.n_kv_heads, cfg.head_dim),
               ("layers", "batch", None, None, None), "zeros")
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv,
            "k_pos": Spec((b, cap), ("batch", None), "zeros"),
            "pos": Spec((b,), ("batch",), "zeros")}


def init_cache(cfg: ModelConfig, batch_size: int, context_len: int,
               device: torch.device) -> Dict:
    """Every k/v leaf in bf16, as in the JAX package; ``k_pos = -1`` marks
    an empty slot."""
    tree = cache_specs(cfg, batch_size, context_len)
    cache = {name: torch.zeros(tree[name].shape, dtype=torch.bfloat16,
                               device=device)
             for name in ("k", "v", "xk", "xv")}
    cache["k_pos"] = torch.full(tree["k_pos"].shape, -1, dtype=torch.int32,
                                device=device)
    cache["pos"] = torch.zeros(tree["pos"].shape, dtype=torch.int32,
                               device=device)
    return cache


def prefill(cfg: ModelConfig, params: Dict, batch: Dict,
            context_len: Optional[int] = None):
    """Encode frames, build the cross-attn cache, run decoder over prompt.
    ``batch["prompt_lens"]`` is not read, as in the JAX package."""
    frames, tokens = batch["frames"], batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    context_len = context_len if context_len is not None else s
    enc_out = encode(cfg, params, frames)
    cache = init_cache(cfg, b, context_len, device=dev)
    x = nn.embed(params["embed"], tokens)
    pos = torch.arange(s, device=dev)
    fpos = torch.arange(enc_out.shape[1], device=dev)
    ks, vs, xks, xvs = [], [], [], []
    for i in range(cfg.num_layers):
        x, (k, v), (xk, xv) = _dec_layer_fwd(
            cfg, tree_index(params["dec_layers"], i), x, enc_out, pos, fpos)
        ks.append(k)
        vs.append(v)
        xks.append(xk)
        xvs.append(xv)
    x = nn.rmsnorm(x, params["final_norm"])
    logits = _matmul(x[:, -1:, :], params["lm_head"])
    axes = cache_specs(cfg, b, context_len)["k"].axes
    cache["k"] = nn.fill_cache(cache["k"], torch.stack(ks), axes)
    cache["v"] = nn.fill_cache(cache["v"], torch.stack(vs), axes)
    # the cross-attention caches take the stacks' dtype, as in the JAX
    # package
    cache["xk"], cache["xv"] = torch.stack(xks), torch.stack(xvs)
    cache["k_pos"][:, :s] = torch.arange(s, dtype=torch.int32,
                                         device=dev)[None]
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=dev)
    return logits, cache


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, batch: Dict):
    """One token for every row. batch: {"token": (B,1)}. The self-attention
    k/v tensors of ``cache`` are updated IN PLACE and returned in the new
    cache dict; ``k_pos``/``pos`` are new tensors."""
    tok = batch["token"]
    x = nn.embed(params["embed"], tok)                   # (B,1,D)
    pos = cache["pos"]                                   # (B,)
    positions = pos[:, None]
    slot = pos                                           # no wrap
    slots = torch.arange(cache["k_pos"].shape[1], device=pos.device)
    k_pos = torch.where(slots[None, :] == slot[:, None], pos[:, None],
                        cache["k_pos"])
    fpos = torch.arange(cfg.n_enc_frames, device=pos.device)
    for i in range(cfg.num_layers):
        p = tree_index(params["dec_layers"], i)
        h = nn.rmsnorm(x, p["ln1"])
        sa = p["self_attn"]
        q = split_heads(_matmul(h, sa["wq"]), cfg.n_heads, cfg.head_dim)
        k = split_heads(_matmul(h, sa["wk"]), cfg.n_kv_heads, cfg.head_dim)
        v = split_heads(_matmul(h, sa["wv"]), cfg.n_kv_heads, cfg.head_dim)
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)
        kc = nn.masked_cache_update(cache["k"][i], k, slot)
        vc = nn.masked_cache_update(cache["v"][i], v, slot)
        ctx = nn.attend(q, kc, vc, positions, k_pos, causal=True)
        x = x + _matmul(merge_heads(ctx), sa["wo"])
        hx = nn.rmsnorm(x, p["ln_x"])
        ca = p["cross_attn"]
        qx = split_heads(_matmul(hx, ca["wq"]), cfg.n_heads, cfg.head_dim)
        ctx = nn.attend(qx, cache["xk"][i], cache["xv"][i], positions, fpos,
                        causal=False)
        x = x + _matmul(merge_heads(ctx), ca["wo"])
        h2 = nn.rmsnorm(x, p["ln2"])
        x = x + _mlp2(p["mlp"], h2)
    x = nn.rmsnorm(x, params["final_norm"])
    logits = _matmul(x, params["lm_head"])
    new_cache = dict(cache)
    new_cache["k_pos"] = k_pos
    new_cache["pos"] = pos + 1
    return logits, new_cache
