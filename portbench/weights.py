"""Seeded weights of a configuration, made by the benchmark on the device and
handed, the same tensors, to the program and to the reference.

The layout is the program's parameter tree (stacked ``layers`` leading
axis): ``embed`` (V, d); ``layers``: ``ln1``, ``ln2`` (L, d), ``attn``
(``wq`` (L, d, H*D), ``wk``/``wv`` (L, d, KH*D), ``wo`` (L, H*D, d), and
``q_norm``/``k_norm`` (L, D) with qk-norm), then ``mlp`` (``wi`` the gate,
``wg`` the up projection (L, d, F), ``wo`` (L, F, d)) or ``moe``
(``router`` (L, d, E), ``wi``/``wg`` (L, E, d, F), ``wo`` (L, E, F, d));
``final_norm`` (d,); ``lm_head`` (d, V) unless the embedding is tied. A
norm's weight is ``1 + w``.

All leaves are views of one flat buffer in the served dtype, filled from a
``torch.Generator`` on the device in slices of ONE_DRAW elements, then each
leaf scaled in place: a matrix by 1 / sqrt(fan in); in a model with
experts, the projections back into the residual stream (``attn.wo``, the
experts' ``wo``) by 1 / sqrt(2 L) more (GPT-2's residual scaling) and the
embedding by EMBED_STD, so that a token's own embedding still shows in the
stream after the last layer and the router's choices spread over the
experts as a trained router's do (without it the random stream of every
token tends to one direction, a few experts take most choices, and many
drop past capacity); a tied embedding, which is also the head, by
HEAD_GAIN / sqrt(d) (were the stream its own embedding, every token would
predict itself), as an untied head: logits of a few units, as a trained
model's; norms by NORM_STD around the published weight of one.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ONE_DRAW = 2 ** 30
EMBED_STD = 1.0
HEAD_GAIN = 3.0
NORM_STD = 0.1


def dims(cfg: dict) -> dict:
    """The sizes the layout and the reference use, from the published keys."""
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    return {"d": d, "L": cfg["num_hidden_layers"], "H": h,
            "KH": cfg["num_key_value_heads"],
            "D": cfg.get("head_dim") or d // h,
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "E": cfg.get("num_local_experts", 0),
            "K": cfg.get("num_experts_per_tok", 0),
            "qk_norm": cfg["model_type"] == "qwen3",
            "tied": bool(cfg["tie_word_embeddings"])}


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(dotted name, shape, std) of every leaf, in the order drawn."""
    m = dims(cfg)
    d, L, F, V, E = m["d"], m["L"], m["F"], m["V"], m["E"]
    q, kv = m["H"] * m["D"], m["KH"] * m["D"]
    res = (2 * L) ** -0.5 if E else 1.0
    embed = HEAD_GAIN * d ** -0.5 if m["tied"] else EMBED_STD
    out = [("embed", (V, d), embed),
           ("layers.ln1", (L, d), NORM_STD),
           ("layers.ln2", (L, d), NORM_STD),
           ("layers.attn.wq", (L, d, q), d ** -0.5),
           ("layers.attn.wk", (L, d, kv), d ** -0.5),
           ("layers.attn.wv", (L, d, kv), d ** -0.5),
           ("layers.attn.wo", (L, q, d), res * q ** -0.5)]
    if m["qk_norm"]:
        out += [("layers.attn.q_norm", (L, m["D"]), NORM_STD),
                ("layers.attn.k_norm", (L, m["D"]), NORM_STD)]
    if E:
        out += [("layers.moe.router", (L, d, E), d ** -0.5),
                ("layers.moe.wi", (L, E, d, F), d ** -0.5),
                ("layers.moe.wg", (L, E, d, F), d ** -0.5),
                ("layers.moe.wo", (L, E, F, d), res * F ** -0.5)]
    else:
        out += [("layers.mlp.wi", (L, d, F), d ** -0.5),
                ("layers.mlp.wg", (L, d, F), d ** -0.5),
                ("layers.mlp.wo", (L, F, d), res * F ** -0.5)]
    out.append(("final_norm", (d,), NORM_STD))
    if not m["tied"]:
        out.append(("lm_head", (d, V), HEAD_GAIN * d ** -0.5))
    return out


def make(cfg: dict, seed: int, device, dtype: torch.dtype = torch.bfloat16
         ) -> Dict:
    """The nested parameter tree, every leaf a view of one buffer."""
    leaves = layout(cfg)
    total = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    flat = torch.empty(total, dtype=dtype, device=device)
    for start in range(0, total, ONE_DRAW):
        flat[start:start + ONE_DRAW].normal_(generator=gen)
    tree: Dict = {}
    at = 0
    for name, shape, std in leaves:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        leaf.mul_(std)
        at += n
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree
