"""Warm-pool forecasting on the card: the predictive prewarmer's fused
Holt-linear + gap-histogram tick as eager torch ops over the columnar
per-(function, platform) state (repro_torch.autoscale.forecast).

One call advances every managed row: Holt level/trend smoothing of the
tick's arrival counts, inter-arrival-gap histogram scatter (one-hot — the
row count is tiny relative to a device pass), Little's-law desired-pool
sizing, and the gap-quantile keep-alive TTL.  It mirrors the JAX package's
jitted tick op for op, at its width: float32, as the JAX package computes
without x64, and every scalar argument a 0-d float32 tensor on the state's
device, as ``jax.jit`` traces a Python float (so ``alpha * beta`` is a
float32 product of two float32-rounded values).  The NumPy reference in
``repro_torch.autoscale.forecast`` stays the parity oracle: tests pin
byte-identical prewarm decisions (desired pools and TTL ticks) from both
backends on seeded arrival streams.  Caveat: the oracle is float64 — a
demand landing exactly on an integer in one precision could in principle
flip a ceil; parity is pinned empirically.

Three points where a literal translation would drift:

  * the gap bucket ``floor(log2(max(idle, 1)))`` is read from the float's
    exponent (``torch.frexp``), which is exact for every idle count; a
    ``log2`` carries an error bound and may land just under k at
    ``idle = 2**k``;
  * ``jnp.argmax`` over a bool mask returns the first true; the mask is
    cast to int32 before ``torch.argmax``, which returns the first maximum;
  * a demand in (-1, 0) ceils to -0.0, which XLA's ``max`` with the hold
    floor turns into +0.0 and torch's keeps: the desired pool gets +0.0
    added, so its bytes are the jitted tick's.

This is no hand-written kernel: the JAX package's tick is ``jax.jit``, not
Pallas, and its port is these torch ops on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

_INT = torch.int32


def gap_bucket(idle_ticks: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """``clip(floor(log2(max(idle, 1))), 0, n_buckets - 1)`` as int32,
    from the float's exponent: ``frexp`` gives ``x = m * 2**e`` with
    ``m`` in [0.5, 1), so ``floor(log2(x)) = e - 1`` for every x >= 1."""
    _, e = torch.frexp(torch.clamp_min(idle_ticks, 1.0))
    return torch.clamp(e - 1, 0, n_buckets - 1).to(_INT)


def predictive_tick(counts, level, trend, idle_ticks, hist, coeff,
                    alpha, beta, min_demand, max_pool, quantile,
                    default_ttl, min_ttl, max_ttl, min_gap_obs,
                    hold_thr) -> Tuple[torch.Tensor, ...]:
    """Fused forecaster tick; returns the advanced state plus decisions:
    (level, trend, idle_ticks, hist, desired, ttl_ticks).  Row columns are
    float32 tensors of shape (n,), ``hist`` (n, n_buckets); the scalars are
    0-d float32 tensors on the same device."""
    pred = level + trend
    err = counts - pred
    new_level = pred + alpha * err
    new_trend = trend + (alpha * beta) * err

    active = counts > 0.0
    gap_closed = active & (idle_ticks > 0.0)
    bucket = gap_bucket(idle_ticks, hist.shape[1])
    iota = torch.arange(hist.shape[1], dtype=_INT, device=hist.device)
    onehot = (iota[None, :] == bucket[:, None]) & gap_closed[:, None]
    new_hist = hist + onehot.to(hist.dtype)
    new_idle = torch.where(active, 0.0, idle_ticks + 1.0)

    rate = torch.clamp_min(new_level + new_trend, 0.0)
    hold = (rate >= hold_thr).to(counts.dtype)       # warm floor of one
    desired = torch.minimum(torch.clamp_min(torch.maximum(
        torch.ceil(rate * coeff - min_demand), hold), 0.0), max_pool)
    # torch's maximum keeps the -0.0 that ceil gives in (-1, 0) where
    # XLA's (and NumPy's) gives +0.0; adding +0.0 turns -0.0 into +0.0
    # and changes no other value
    desired = desired + 0.0

    total = new_hist.sum(dim=1)
    cum = torch.cumsum(new_hist, dim=1)
    first = (cum >= (quantile * total)[:, None]).to(_INT)
    b = torch.argmax(first, dim=1)
    ttl = torch.exp2(b + 1.0)
    ttl = torch.where(total >= min_gap_obs, ttl, default_ttl)
    ttl = torch.minimum(torch.maximum(ttl, min_ttl), max_ttl)
    return new_level, new_trend, new_idle, new_hist, desired, ttl
