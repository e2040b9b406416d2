"""Operations and bytes that the inputs need, from a configuration's
published sizes, and the H100's peaks. Counted from the real prompt lengths
and live keys, never from padded buckets or empty slots, and for a model
with sparse experts from the experts each token is routed to.

Peaks: NVIDIA's data sheet for the H100 SXM, dense bf16 on the tensor
cores, HBM3 bandwidth, at the full 700 W limit.
"""
from __future__ import annotations

from typing import Iterable, Optional

from portbench.weights import dims

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def matmul_flops_per_token(cfg: dict) -> float:
    """2 flops a multiply-add over every weight a token meets in one layer:
    the attention projections, then the MLP, or the router and the experts
    it is routed to."""
    m = dims(cfg)
    d, q, kv = m["d"], m["H"] * m["D"], m["KH"] * m["D"]
    attn = d * q + 2 * d * kv + q * d
    if m["E"]:
        ffn = d * m["E"] + m["K"] * 3 * d * m["F"]
    else:
        ffn = 3 * d * m["F"]
    return 2.0 * (attn + ffn)


def head_flops(cfg: dict) -> float:
    m = dims(cfg)
    return 2.0 * m["d"] * m["V"]


def causal_pairs(s: int, window: Optional[int] = None) -> int:
    """(query, key) pairs a causal attention over s positions computes."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    w = window
    return w * (w + 1) // 2 + (s - w) * w


def prefill_flops(cfg: dict, n: int) -> float:
    """A prompt of n tokens: every layer over n tokens, attention over its
    causal pairs (4*D flops a pair and head: two products), and the head at
    the last position only."""
    m = dims(cfg)
    window = cfg.get("window") or cfg.get("sliding_window")
    attn = 4.0 * m["D"] * m["H"] * causal_pairs(n, window)
    return m["L"] * (n * matmul_flops_per_token(cfg) + attn) \
        + head_flops(cfg)


def decode_flops(cfg: dict, keys: Iterable[int]) -> float:
    """One decode step: one token for each active row, attending over its
    live keys."""
    m = dims(cfg)
    keys = list(keys)
    per_row = m["L"] * matmul_flops_per_token(cfg) + head_flops(cfg)
    attn = m["L"] * 4.0 * m["D"] * m["H"] * sum(keys)
    return len(keys) * per_row + attn


def bound_s(flops: float, nbytes: float,
            peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time on the card: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def attention_bound_s(b: int, s: int, h: int, kh: int, d: int,
                      window: Optional[int] = None) -> float:
    """Least time for one causal bf16 prefill attention call: q, k, v read
    once and the output written once (2 bytes each); 4*D flops (two
    products) for every unmasked (query, key) pair, at the bf16 tensor-core
    rate. (The same count as ``chip_smoke.attention_bound``.)"""
    pairs = causal_pairs(s, window)
    return bound_s(4 * d * b * h * pairs,
                   2 * (2 * b * s * h * d + 2 * b * s * kh * d))
