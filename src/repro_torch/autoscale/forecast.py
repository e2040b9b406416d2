"""Arrival forecasting for the warm-pool controller (repro_torch.autoscale).

State is *columnar*: one row per managed (function, platform) pair, all
rows advanced together by one fused array pass per controller tick —
Holt-linear (EWMA level + trend) smoothing of per-tick arrival counts,
plus a log2-bucketed inter-arrival-gap histogram that turns observed
burstiness into an adaptive keep-alive TTL.  From those the predictive
prewarmer derives, per row,

  * ``desired`` — warm replicas to hold ready: Little's-law demand
    ``forecast rate x predicted exec seconds`` with head-room, ceil'd;
  * ``ttl``     — how long an idle replica stays warm: the gap histogram's
    ``quantile`` (next power-of-two ticks), i.e. "keep alive while the
    next arrival is probably closer than that".

NumPy is the reference backend (float64 host arrays); a torch mirror on
the forecast device lives in ``repro_torch.kernels.warm_forecast``,
following the ``policy_score`` pattern — NumPy stays the parity oracle
(tests pin byte-identical prewarm decisions from both backends), so the
backend choice is a throughput knob, not a semantic one.  ``auto`` uses
NumPy below ``TORCH_FORECAST_MIN`` rows (tiny states are dominated by
dispatch overhead) and torch above it (pod-scale registries).
``set_forecast_device`` picks where the torch backend computes: the CUDA
card unless the caller asks for the CPU.  There is no silent degrade: the
torch module is imported directly, and a torch tick without a card raises.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import warm_forecast as wf

# Minimum row count at which "auto" switches to the torch tick.
# chip_smoke.py times one tick (state and counts in, decisions on the host)
# at R managed rows, NumPy against torch on the card (NVIDIA H100 80GB HBM3,
# 700 W; host ms, median of three turns): R=25 0.0399 / 0.764; R=256 0.0984
# / 0.802; R=4096 0.655 / 1.214; R=65536 10.23 / 8.14. Torch led in every
# turn only at R=65536.
TORCH_FORECAST_MIN = 65536

_BACKENDS = ("numpy", "torch", "auto")
_FORECAST_BACKEND = os.environ.get("FDN_FORECAST_BACKEND", "auto")
_FORECAST_DEVICE: DeviceLike = None


def set_forecast_backend(mode: str) -> None:
    """Select the forecaster backend: "numpy", "torch", or "auto"."""
    if mode not in _BACKENDS:
        raise ValueError(f"unknown forecast backend {mode!r}")
    global _FORECAST_BACKEND
    _FORECAST_BACKEND = mode


def get_forecast_backend() -> str:
    return _FORECAST_BACKEND


def set_forecast_device(device: DeviceLike) -> None:
    """Where the torch backend computes: ``None`` (the default) is the CUDA
    card, and raises ``NoCudaDevice`` at the first torch tick on a machine
    without one; ``"cpu"`` asks for the CPU."""
    global _FORECAST_DEVICE
    _FORECAST_DEVICE = device


def get_forecast_device() -> DeviceLike:
    return _FORECAST_DEVICE


@contextlib.contextmanager
def forecast_settings(backend: str, device: DeviceLike):
    """The forecaster backend and device for the block; the earlier
    settings are put back after it."""
    saved = (_FORECAST_BACKEND, _FORECAST_DEVICE)
    set_forecast_backend(backend)
    set_forecast_device(device)
    try:
        yield
    finally:
        set_forecast_backend(saved[0])
        set_forecast_device(saved[1])


def _use_torch(n_rows: int, override: Optional[str]) -> bool:
    mode = override or _FORECAST_BACKEND
    if mode not in _BACKENDS:
        raise ValueError(f"unknown forecast backend {mode!r} "
                         f"(FDN_FORECAST_BACKEND); want one of {_BACKENDS}")
    if mode == "numpy":
        return False
    return not (mode == "auto" and n_rows < TORCH_FORECAST_MIN)


@dataclass(frozen=True)
class ForecastParams:
    """Knobs of the predictive prewarmer (all rows share one set)."""
    alpha: float = 0.5          # Holt level smoothing
    beta: float = 0.3           # Holt trend smoothing
    headroom: float = 2.0       # demand safety multiplier (Poisson bursts)
    quantile: float = 0.9       # gap-histogram keep-alive quantile
    n_buckets: int = 12         # log2 gap buckets (ticks)
    min_demand: float = 0.05    # demand below this rounds to zero pool
    max_pool: int = 16          # per-row prewarm cap
    # hold at least one replica warm while the forecast rate says an
    # arrival is coming soon (>= hold_min_rps): for fast functions the
    # Little's-law demand rounds to zero even under steady traffic, but a
    # cold start would still hit every post-TTL arrival
    hold_min_rps: float = 0.05
    default_ttl_ticks: float = 30.0   # before the histogram has data
    min_ttl_ticks: float = 25.0       # keep-alive floor: surplus replicas
                                      # outlive short Poisson lulls
    max_ttl_ticks: float = 900.0
    min_gap_obs: int = 3        # histogram observations before trusting it


class ForecastState:
    """Growable columnar state: one row per (function, platform)."""

    __slots__ = ("level", "trend", "idle_ticks", "hist", "n")

    def __init__(self, n_buckets: int):
        self.n = 0
        self.level = np.zeros(0)
        self.trend = np.zeros(0)
        self.idle_ticks = np.zeros(0)
        self.hist = np.zeros((0, n_buckets))

    def resize(self, n: int) -> None:
        if n <= self.n:
            return
        grow = n - self.n
        self.level = np.concatenate([self.level, np.zeros(grow)])
        self.trend = np.concatenate([self.trend, np.zeros(grow)])
        self.idle_ticks = np.concatenate([self.idle_ticks, np.zeros(grow)])
        self.hist = np.concatenate(
            [self.hist, np.zeros((grow, self.hist.shape[1]))])
        self.n = n


def holt_zero_matrix(alpha: float, beta: float,
                     k: int) -> Tuple[float, float, float, float]:
    """``M^k`` for the Holt zero-observation step ``[l, t] <- M [l, t]``
    with ``M = [[1-a, 1-a], [-a*b, 1-a*b]]`` — the closed form that lets
    a run of ``k`` arrival-free ticks be applied in one vectorized pass
    (binary exponentiation over Python floats: deterministic).

    Policies use this to go *dormant* while no arrivals flow: cached
    decisions are returned instantly and the decayed state is caught up
    exactly when traffic resumes."""
    m = (1.0 - alpha, 1.0 - alpha, -alpha * beta, 1.0 - alpha * beta)
    r = (1.0, 0.0, 0.0, 1.0)
    while k:
        if k & 1:
            r = (r[0] * m[0] + r[1] * m[2], r[0] * m[1] + r[1] * m[3],
                 r[2] * m[0] + r[3] * m[2], r[2] * m[1] + r[3] * m[3])
        m = (m[0] * m[0] + m[1] * m[2], m[0] * m[1] + m[1] * m[3],
             m[2] * m[0] + m[3] * m[2], m[2] * m[1] + m[3] * m[3])
        k >>= 1
    return r


def ttl_from_hist(hist: np.ndarray, p: ForecastParams) -> np.ndarray:
    """Per-row keep-alive TTL in ticks: the next power of two above the
    gap histogram's ``quantile``; rows with too few observed gaps fall
    back to the default TTL."""
    total = hist.sum(axis=1)
    cum = np.cumsum(hist, axis=1)
    need = p.quantile * total
    b = np.argmax(cum >= need[:, None], axis=1)
    ttl = np.exp2(b + 1.0)
    ttl = np.where(total >= p.min_gap_obs, ttl, p.default_ttl_ticks)
    return np.clip(ttl, p.min_ttl_ticks, p.max_ttl_ticks)


def predictive_tick_numpy(state: ForecastState, counts: np.ndarray,
                          coeff: np.ndarray, p: ForecastParams,
                          has_arrivals: bool,
                          desired_out: np.ndarray,
                          scratch: np.ndarray,
                          ttl_cache: np.ndarray,
                          hold_buf: np.ndarray,
                          hold_thr: float = 0.0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """One fused forecaster tick over all rows (reference backend).

    ``coeff`` is the precomputed ``exec_s * headroom / tick_s`` column, so
    ``demand = max(level + trend, 0) * coeff``; ``hold_thr`` is
    ``hold_min_rps * tick_s`` (the warm-floor threshold in forecast
    counts-per-tick units).  Zero-arrival ticks take
    the identical formulas (counts == 0 just decays level/trend and ages
    the idle counters); only the histogram/TTL work — a pure function of
    arrivals — is skipped, so the fast path is an optimization, not a
    semantic fork.  Everything is in-place over caller-owned buffers: the
    controller tick makes no allocations in steady state."""
    level, trend = state.level, state.trend
    pred = scratch
    # Holt: new_level = pred + a*err, new_trend = trend + a*b*err
    np.add(level, trend, out=pred)
    if has_arrivals:
        err = counts - pred
        np.add(pred, p.alpha * err, out=level)
        trend += (p.alpha * p.beta) * err
        # close inter-arrival gaps into the histogram
        gap_rows = np.flatnonzero((counts > 0.0) & (state.idle_ticks > 0.0))
        if gap_rows.size:
            gaps = state.idle_ticks[gap_rows]
            buckets = np.clip(np.floor(np.log2(gaps)).astype(np.int64), 0,
                              p.n_buckets - 1)
            np.add.at(state.hist, (gap_rows, buckets), 1.0)
            ttl_cache[:] = ttl_from_hist(state.hist, p)
        state.idle_ticks += 1.0
        state.idle_ticks[counts > 0.0] = 0.0
    else:                          # counts == 0 everywhere: err = -pred
        np.multiply(pred, 1.0 - p.alpha, out=level)
        np.multiply(pred, p.alpha * p.beta, out=pred)
        np.subtract(trend, pred, out=trend)
        state.idle_ticks += 1.0
    # demand -> desired pool (ceil with a dead-band below min_demand,
    # floored at one warm replica while arrivals are forecast soon)
    np.add(level, trend, out=pred)
    np.maximum(pred, 0.0, out=pred)
    np.greater_equal(pred, hold_thr, out=hold_buf)   # counts per tick
    np.multiply(pred, coeff, out=pred)
    np.subtract(pred, p.min_demand, out=pred)
    np.ceil(pred, out=pred)
    np.maximum(pred, hold_buf, out=pred)     # bool broadcast: floor of 1
    np.minimum(pred, float(p.max_pool), out=desired_out)
    return desired_out, ttl_cache


def predictive_tick_torch(state: ForecastState, counts: np.ndarray,
                          coeff: np.ndarray, p: ForecastParams,
                          desired_out: np.ndarray, ttl_cache: np.ndarray,
                          hold_thr: float = 0.0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """The torch mirror on the forecast device: the row columns go over in
    one float32 block (one host-to-device copy), the scalars in another,
    the advanced state and decisions come back in one block, and the state
    is written back into the float64 host arrays — so, as with the JAX
    package's jitted tick, it is rounded to float32 on every arrival
    tick."""
    dev = resolve(_FORECAST_DEVICE)
    n, nb = state.hist.shape
    rows = np.empty((5 + nb, n), dtype=np.float32)
    rows[0], rows[1], rows[2] = counts, state.level, state.trend
    rows[3], rows[4], rows[5:] = state.idle_ticks, coeff, state.hist.T
    scal = torch.tensor(
        [p.alpha, p.beta, p.min_demand, float(p.max_pool), p.quantile,
         p.default_ttl_ticks, p.min_ttl_ticks, p.max_ttl_ticks,
         float(p.min_gap_obs), hold_thr], dtype=torch.float32).to(dev)
    r = torch.from_numpy(rows).to(dev)
    level, trend, idle, hist, desired, ttl = wf.predictive_tick(
        r[0], r[1], r[2], r[3], r[5:].T, r[4], *scal.unbind())
    out = torch.cat([torch.stack([level, trend, idle, desired, ttl]),
                     hist.T]).cpu().numpy().astype(np.float64)
    state.level, state.trend, state.idle_ticks = out[0], out[1], out[2]
    state.hist = np.ascontiguousarray(out[5:].T)
    desired_out[:] = out[3]
    ttl_cache[:] = out[4]
    return desired_out, ttl_cache
