"""The plain reference of the benchmark's decoder-only configurations: a
dense transformer with qk-norm (Qwen3) and one with sparse experts
(Mixtral), written from the published descriptions in plain PyTorch. It
imports nothing of the program and takes only the benchmark's weights and
token ids.

It runs the whole sequence (prompt, then the served tokens) at once, with
no cache and no batching, in float32 with TF32 off, one layer at a time
over every sequence (each layer's weights are cast to f32 when it runs, so a
model whose f32 copy would not fit is worked out a layer at a time), and
attention in blocks of Q_BLOCK query rows.

What it follows, and the departures from the published models:

* RMSNorm ``x / sqrt(mean(x^2) + eps) * (1 + w)`` (the benchmark's weights
  hold ``w``, the published ``weight`` less one); ``eps`` is the
  configuration's ``rms_norm_eps``.
* Rotary embedding in the half-split (NeoX) form, ``theta`` from the file;
  Qwen3's per-head RMSNorm of q and k before it; grouped-query attention,
  causal, within ``window`` where the configuration states one.
* A SwiGLU MLP ``(silu(x Wg) * (x Wu)) Wd``; Mixtral's router: softmax of
  ``x Wr`` in f32, the top ``num_experts_per_tok`` (the lower index first
  among equal scores), renormalised; every choice is taken (no capacity,
  no drops), as in the published model.

``precision="fp8"`` is the control: every product of a weight (attention
projections, MLP and experts, head) takes its two operands rounded to
float8 e4m3, the weight by output column and the activation by row, each
with its own scale; the router, norms and attention stay f32.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

Q_BLOCK = 1024
FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    def __init__(self, cfg: dict, tree: Dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision is f32 or fp8; got {precision!r}")
        self.cfg = cfg
        self.tree = tree
        self.precision = precision
        d = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.KH = cfg["num_key_value_heads"]
        self.D = cfg.get("head_dim") or d // self.H
        self.L = cfg["num_hidden_layers"]
        self.E = cfg.get("num_local_experts", 0)
        self.K = cfg.get("num_experts_per_tok", 0)
        self.eps = cfg["rms_norm_eps"]
        self.theta = float(cfg["rope_theta"])
        self.window = cfg.get("window") or cfg.get("sliding_window")
        self.margins: List[Optional[torch.Tensor]] = []

    # ------------------------------------------------------------ pieces --
    def lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.precision == "fp8":
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        var = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * (1.0 + w.float())

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        half = x.shape[-1] // 2
        inv = self.theta ** (-torch.arange(half, dtype=torch.float32,
                                           device=x.device) / half)
        ang = pos[:, None].float() * inv                     # (S, D/2)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attention(self, q, k, v):
        """q (S,H,D), k/v (S,KH,D), causal over positions 0..S-1."""
        s = q.shape[0]
        g = self.H // self.KH
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        kpos = torch.arange(s, device=q.device)
        out = torch.empty_like(q)
        for q0 in range(0, s, Q_BLOCK):
            q1 = min(q0 + Q_BLOCK, s)
            sc = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) \
                * self.D ** -0.5
            qpos = torch.arange(q0, q1, device=q.device)[:, None]
            ok = kpos[None, :q1] <= qpos
            if self.window:
                ok &= kpos[None, :q1] > qpos - self.window
            sc = sc.masked_fill(~ok, float("-inf"))
            out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                      v[:q1])
        return out

    def mlp(self, x, p):
        return self.lin(F.silu(self.lin(x, p["wi"])) * self.lin(x, p["wg"]),
                        p["wo"])

    def moe(self, x, p):
        """x (S, d); also gives each row's routing margin: the k-th choice's
        probability less the next one's."""
        probs = torch.softmax(x @ p["router"].float(), dim=-1)   # (S, E)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        margin = top_p[:, self.K - 1] - top_p[:, self.K]
        top_p, top_i = top_p[:, :self.K], top_i[:, :self.K]
        gate = top_p / top_p.sum(-1, keepdim=True)
        out = torch.zeros_like(x)
        for e in range(self.E):
            tok, slot = torch.nonzero(top_i == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            pe = {n: p[n][e] for n in ("wi", "wg", "wo")}
            y = self.mlp(x[tok], pe)
            out.index_add_(0, tok, y * gate[tok, slot, None])
        return out, margin

    def layer(self, h, i: int):
        """Layer i over one sequence: (h, each row's routing margin, or
        None without experts)."""
        lw = self.tree["layers"]
        a = {n: t[i] for n, t in lw["attn"].items()}
        s = h.shape[0]
        pos = torch.arange(s, device=h.device)
        x = self.norm(h, lw["ln1"][i])
        q = self.lin(x, a["wq"]).view(s, self.H, self.D)
        k = self.lin(x, a["wk"]).view(s, self.KH, self.D)
        v = self.lin(x, a["wv"]).view(s, self.KH, self.D)
        if "q_norm" in a:
            q = self.norm(q, a["q_norm"])
            k = self.norm(k, a["k_norm"])
        q, k = self.rope(q, pos), self.rope(k, pos)
        h = h + self.lin(self.attention(q, k, v).reshape(s, -1), a["wo"])
        x = self.norm(h, lw["ln2"][i])
        if "moe" in lw:
            p = {n: t[i] for n, t in lw["moe"].items()}
            y, margin = self.moe(x, p)
            return h + y, margin
        p = {n: t[i] for n, t in lw["mlp"].items()}
        return h + self.mlp(x, p), None

    # ------------------------------------------------------------ whole --
    @torch.no_grad()
    def logits(self, seqs: List[torch.Tensor],
               n_prompts: List[int]) -> List[torch.Tensor]:
        """For each sequence (prompt then served tokens but the last, int64
        on the weights' device), the f32 logits (S - n + 1, V) at positions
        n-1..S-1: those that predict each served token. ``self.margins``
        then holds, for the same positions, the smallest routing margin over
        the layers (None without experts)."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            hs = [self.tree["embed"][s].float() for s in seqs]
            margins = [None] * len(seqs)
            for i in range(self.L):
                for j in range(len(seqs)):
                    hs[j], m = self.layer(hs[j], i)
                    if m is not None:
                        margins[j] = m if margins[j] is None else \
                            torch.minimum(margins[j], m)
            self.margins = [None if m is None else m[n - 1:]
                            for m, n in zip(margins, n_prompts)]
            head = (self.tree["embed"].T if "lm_head" not in self.tree
                    else self.tree["lm_head"])
            return [self.lin(self.norm(h[n - 1:], self.tree["final_norm"]),
                             head) for h, n in zip(hs, n_prompts)]
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


def served_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor,
                margins: Optional[torch.Tensor] = None,
                min_margin: float = 0.0) -> torch.Tensor:
    """How far each served token's logit lies below the reference's best at
    its position, at the positions whose routing margin is at least
    ``min_margin`` in every layer (every position without experts)."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens[:, None].long())[:, 0]
    gap = best - got
    return gap if margins is None else gap[margins >= min_margin]


def gap_numbers(gaps: List[torch.Tensor]) -> Dict[str, float]:
    """The widest and the mean gap over every compared position, and how
    many positions were compared."""
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    return {"max_logit_gap": float(g.max()) if g.numel() else 0.0,
            "mean_logit_gap": float(g.mean()) if g.numel() else 0.0,
            "compared_tokens": int(g.numel())}
