"""Mixture-of-Experts block (mixtral-8x7b top-2, dbrx top-4), ported from the
JAX package's ``models/moe.py``.

Capacity-based dispatch: tokens are grouped (one group per batch row),
routed with top-k, and dispatched to experts. The default ``moe_impl``
("einsum") dispatches and combines through one-hot einsums; "sorted" sorts
each group's (token, choice) pairs by expert and scatters them into the
experts' buffers. Both keep the group-local capacity and drop the same
choices: a choice takes the next free slot of its expert in (token,
choice)-major order, and a choice past the expert's capacity is dropped.
The router runs in f32; everything else in the activations' dtype.

Pad tokens of a right-padded prompt are routed like any other token and
take capacity, as in the JAX package (they come after the prompt's tokens,
so they only ever take slots no prompt token wanted; the capacity itself
follows the padded length).

"sorted_shmap" runs the sorted dispatch on each data-parallel shard's
local tokens (``_sorted_shard_map``, the JAX package's shard_map body) and
falls back to the plain sorted dispatch where the JAX package does: no
mesh, a batch that does not divide the data axes, or experts sharded.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import Spec
from repro_torch.sharding import constrain


def moe_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": Spec((d, e), ("embed", "experts")),
        "wi": Spec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wg": Spec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wo": Spec((e, f, d), ("experts", "expert_mlp", "embed")),
    }


def _capacity(cfg: ModelConfig, group_tokens: int) -> int:
    cap = int(group_tokens * cfg.top_k * cfg.capacity_factor
              // cfg.n_experts)
    return max(cap, cfg.top_k)


def route(cfg: ModelConfig, p: Dict, x: torch.Tensor):
    """The f32 router: (probs (B,S,E), renormalised top_p (B,S,k), top_i
    (B,S,k), load-balancing aux loss). ``jax.lax.top_k`` puts the lower
    index first among equal values; a stable descending sort does too
    (``torch.topk`` promises no order among ties)."""
    e, k = cfg.n_experts, cfg.top_k
    gate_logits = x.float() @ p["router"].float()
    probs = torch.softmax(gate_logits, dim=-1)               # (B,S,E)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)             # renormalize
    # Load-balancing auxiliary loss (Switch/Mixtral style).
    me = probs.mean(dim=(0, 1))                              # (E,)
    ce = F.one_hot(top_i[..., 0], e).float().mean(dim=(0, 1))
    aux = cfg.router_aux_coef * e * (me * ce).sum()
    return probs, top_p, top_i, aux


def moe_block(cfg: ModelConfig, p: Dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_load_balance_loss). Groups = batch rows."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, s)
    if cfg.moe_impl == "sorted_shmap":
        return _sorted_shard_map(cfg, p, x)
    _, top_p, top_i, aux = route(cfg, p, x)

    if cfg.moe_impl == "sorted":
        return _sorted_dispatch(cfg, p, x, top_p, top_i, cap), aux

    # Position of each (token, choice) inside its expert's buffer.
    onehot = F.one_hot(top_i, e)                              # (B,S,k,E)
    flat = onehot.reshape(b, s * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, k, e)
    within_cap = pos_in_expert < cap

    # dispatch: (B,S,E,C) one-hot; combine carries the gate weight. A
    # position at or past the capacity has no slot (jax.nn.one_hot gives a
    # zero row there, where F.one_hot would raise).
    slot_oh = (pos_in_expert[..., None] == torch.arange(
        cap, device=x.device)).to(x.dtype)                   # (B,S,k,E,C)
    sel = (onehot * within_cap).to(x.dtype)[..., None]
    dispatch = (slot_oh * sel).sum(dim=2)                     # (B,S,E,C)
    combine = (slot_oh * sel * top_p[..., None, None].to(x.dtype)
               ).sum(dim=2)                                   # (B,S,E,C)

    xe = torch.einsum("bsd,bsec->ebcd", x, dispatch)          # (E,B,C,D)
    xe = constrain(xe, "experts", "batch", None, "embed")
    h = F.silu(torch.einsum("ebcd,edf->ebcf", xe, p["wi"]))
    h = h * torch.einsum("ebcd,edf->ebcf", xe, p["wg"])
    h = constrain(h, "experts", "batch", None, "expert_mlp")
    ye = torch.einsum("ebcf,efd->ebcd", h, p["wo"])           # (E,B,C,D)
    y = torch.einsum("ebcd,bsec->bsd", ye, combine)
    return y, aux


# ---------------------------------------------------------------------------
# Sort-based dispatch: O(T·D) data movement instead of O(T·E·C·D) one-hot
# products. Same group-local capacity/drop semantics as the einsum path (the
# stable sort keeps token order within an expert).
# ---------------------------------------------------------------------------


def _group_sorted(cfg: ModelConfig, wi, wg, wo, xg, pg, ig, cap: int):
    """The sorted dispatch of every group at once (the JAX package vmaps one
    group's over the batch). xg: (B,S,D); pg/ig: (B,S,k) -> (B,S,D)."""
    b, s, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    n = s * k
    dev = xg.device
    gate = pg.reshape(b, n)
    expert = ig.reshape(b, n)
    tok = torch.arange(s, device=dev).repeat_interleave(k)    # (n,)
    order = torch.argsort(expert, dim=1, stable=True)         # (B,n)
    se = torch.gather(expert, 1, order)
    st, sg = tok[order], torch.gather(gate, 1, order)
    seg_start = torch.searchsorted(
        se, torch.arange(e, device=dev).expand(b, e).contiguous(),
        side="left")                                          # (B,E)
    pos = torch.arange(n, device=dev) - torch.gather(seg_start, 1, se)
    slot = torch.where(pos < cap, se * cap + pos, e * cap)    # drop -> tail
    rows = torch.arange(b, device=dev)[:, None]
    buf = torch.zeros(b, e * cap + 1, d, dtype=xg.dtype, device=dev)
    buf[rows, slot] = xg[rows, st]
    xe = buf[:, :e * cap].reshape(b, e, cap, d)               # (B,E,C,D)
    h = F.silu(torch.einsum("becd,edf->becf", xe, wi))
    h = h * torch.einsum("becd,edf->becf", xe, wg)
    ye = torch.einsum("becf,efd->becd", h, wo).reshape(b, e * cap, d)
    ye = torch.cat([ye, torch.zeros(b, 1, d, dtype=ye.dtype, device=dev)],
                   dim=1)
    out_choice = ye[rows, slot] * sg[..., None].to(ye.dtype)
    y = torch.zeros(b, s, d, dtype=xg.dtype, device=dev)
    return y.index_put_((rows, st), out_choice.to(xg.dtype), accumulate=True)


def _sorted_shard_map(cfg: ModelConfig, p: Dict, x: torch.Tensor):
    """Sorted dispatch on each rank's local tokens: every scatter and
    gather runs local to the data-parallel shard, so the dispatch buffers
    are never gathered across ranks.

    Requires the mixtral-style layout (experts replicated, per-expert ffn
    dim sharded over "model"); falls back to the plain sorted dispatch
    without a mesh, when the batch does not divide the dp axes, or when the
    experts are sharded. The body's partial sums over "model" (the ffn dim)
    and its per-shard aux losses leave it as ``Partial`` placements, which
    are reduced on the way out (the reference's psum and pmean), so that
    autograd runs through the reductions.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = shd.current_mesh()
    b = x.shape[0]
    e = cfg.n_experts
    cap = _capacity(cfg, x.shape[1])
    dp = shd.dp_axes(mesh) if mesh is not None else ()
    shape = shd.mesh_shape(mesh) if mesh is not None else {}
    dp_size = 1
    for a in dp:
        dp_size *= shape[a]
    model = shape.get("model", 1)
    experts_sharded = mesh is not None and e % model == 0 and model > 1
    if mesh is None or b % max(dp_size, 1) != 0 or experts_sharded:
        # no mesh / ragged batch / EP layout: the plain paths handle it
        _, top_p, top_i, aux = route(cfg, p, x)
        return _sorted_dispatch(cfg, p, x, top_p, top_i, cap), aux

    def local(xl, router, wi, wg, wo):
        _, top_p, top_i, aux_l = route(cfg, {"router": router}, xl)
        y = _group_sorted(cfg, wi, wg, wo, xl, top_p.to(xl.dtype), top_i,
                          cap)
        return y, aux_l / dp_size

    names = shd.axis_names(mesh)

    def on(dp_p, model_p):
        return tuple(dp_p if a in dp else model_p if a == "model"
                     else Replicate() for a in names)

    rows = (dp, None, None)
    wspec = (None, None, "model")
    out = shd.shard_map(
        local, mesh,
        in_specs=(rows, (), wspec, wspec, (None, "model", None)),
        out_specs=[on(Shard(0), Partial()), on(Partial(), Replicate())],
        in_grad_specs=(on(Shard(0), Partial()), on(Partial(), Partial()),
                       on(Partial(), Shard(2)), on(Partial(), Shard(2)),
                       on(Partial(), Shard(1))),
    )(x, p["router"], p["wi"], p["wg"], p["wo"])
    return tuple(shd.settle(t) for t in out)


def _sorted_dispatch(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     top_p: torch.Tensor, top_i: torch.Tensor,
                     cap: int) -> torch.Tensor:
    return _group_sorted(cfg, p["wi"], p["wg"], p["wo"], x,
                         top_p.to(x.dtype), top_i, cap)
