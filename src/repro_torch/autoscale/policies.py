"""Keep-alive / prewarm policies for the warm-pool controller.

Each policy answers, per managed (function, platform) row and per tick:

  * ``desired`` — how many idle warm replicas to hold ready (the
    controller prewarms up to it);
  * ``ttl_s``   — how long an idle replica may stay warm past its last
    use before the controller retires it (the keep-alive).

All policies are columnar: one fused array pass per tick over every row.

  FixedTTLPolicy            classic FaaS keep-alive: no prewarming, idle
                            replicas die ``ttl_s`` after last use
                            (OpenWhisk's fixed keep-alive window).
  ScaleToZeroPolicy         aggressive idler: tiny TTL, pools drop to
                            zero between arrivals (faas-idler semantics;
                            minimum idle watts, maximum cold starts).
  ConcurrencyTargetPolicy   reactive: EWMA of observed arrival rate
                            sized by Little's law against a per-replica
                            concurrency target (OpenFaaS-style reactive
                            autoscaling, plus a fixed TTL).
  PredictivePolicy          the forecaster: Holt-linear rate forecast +
                            inter-arrival-gap histogram -> prewarm ahead
                            of predicted demand, keep alive for the gap
                            quantile (repro_torch.autoscale.forecast; NumPy
                            reference + torch backend on the forecast
                            device, byte-identical decisions pinned by
                            tests).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np

from repro_torch.autoscale.forecast import (ForecastParams, ForecastState,
                                            _use_torch, holt_zero_matrix,
                                            predictive_tick_numpy,
                                            predictive_tick_torch)


class KeepAlivePolicy:
    """Base: fixed-size desired/TTL columns, grown with the row set."""

    name = "base"
    # forecaster ticks this policy ran on the torch backend
    torch_ticks = 0

    def __init__(self):
        self.n = 0
        self._desired = np.zeros(0)
        self._ttl = np.zeros(0)

    def resize(self, n: int) -> None:
        if n <= self.n:
            return
        grow = n - self.n
        self._desired = np.concatenate([self._desired, np.zeros(grow)])
        self._ttl = np.concatenate(
            [self._ttl, np.full(grow, self.default_ttl_s())])
        self.n = n

    def default_ttl_s(self) -> float:
        return 30.0

    def set_exec(self, exec_s: np.ndarray, tick_s: float) -> None:
        """Per-row predicted execution seconds (Little's-law input);
        refreshed by the controller as the perf model learns."""

    def tick(self, counts: np.ndarray, has_arrivals: bool
             ) -> Tuple[np.ndarray, np.ndarray]:
        """(desired warm replicas, keep-alive TTL seconds) per row."""
        raise NotImplementedError


class FixedTTLPolicy(KeepAlivePolicy):
    name = "ttl"

    def __init__(self, ttl_s: float = 30.0):
        self.ttl_s = float(ttl_s)
        super().__init__()

    def default_ttl_s(self) -> float:
        return self.ttl_s

    def tick(self, counts, has_arrivals):
        return self._desired, self._ttl


class ScaleToZeroPolicy(FixedTTLPolicy):
    name = "scale_to_zero"

    def __init__(self, idle_s: float = 1.0):
        super().__init__(ttl_s=idle_s)


class ConcurrencyTargetPolicy(KeepAlivePolicy):
    name = "concurrency"

    def __init__(self, target: float = 1.0, ttl_s: float = 30.0,
                 alpha: float = 0.3, min_demand: float = 0.05,
                 max_pool: int = 16):
        self.target = max(float(target), 1e-6)
        self.ttl_s = float(ttl_s)
        self.alpha = float(alpha)
        self.min_demand = float(min_demand)
        self.max_pool = float(max_pool)
        super().__init__()
        self._zero_run = 0
        self._level = np.zeros(0)
        self._coeff = np.zeros(0)
        self._scratch = np.zeros(0)

    def default_ttl_s(self) -> float:
        return self.ttl_s

    def resize(self, n: int) -> None:
        if n <= self.n:
            return
        grow = n - self.n
        self._level = np.concatenate([self._level, np.zeros(grow)])
        self._coeff = np.concatenate([self._coeff, np.zeros(grow)])
        self._scratch = np.concatenate([self._scratch, np.zeros(grow)])
        super().resize(n)

    def set_exec(self, exec_s, tick_s):
        np.multiply(exec_s, 1.0 / (self.target * tick_s), out=self._coeff)

    def tick(self, counts, has_arrivals):
        level, scratch = self._level, self._scratch
        if not has_arrivals:
            # dormant: decay is closed-form, decisions frozen until
            # traffic resumes (caught up exactly below)
            self._zero_run += 1
            return self._desired, self._ttl
        if self._zero_run:
            level *= (1.0 - self.alpha) ** self._zero_run
            self._zero_run = 0
        level += self.alpha * (counts - level)
        np.multiply(level, self._coeff, out=scratch)
        np.subtract(scratch, self.min_demand, out=scratch)
        np.ceil(scratch, out=scratch)
        np.maximum(scratch, 0.0, out=scratch)
        np.minimum(scratch, self.max_pool, out=self._desired)
        return self._desired, self._ttl


class PredictivePolicy(KeepAlivePolicy):
    name = "predictive"

    def __init__(self, params: Optional[ForecastParams] = None,
                 backend: Optional[str] = None, **param_overrides):
        self.params = params or ForecastParams(**param_overrides)
        self.backend = backend            # None: module-level setting
        self.state = ForecastState(self.params.n_buckets)
        self.tick_s = 1.0
        self._hold_thr = self.params.hold_min_rps * self.tick_s
        self._zero_run = 0
        super().__init__()
        self._coeff = np.zeros(0)
        self._scratch = np.zeros(0)
        self._hold_buf = np.zeros(0, dtype=bool)
        self._ttl_s_out = np.zeros(0)

    def default_ttl_s(self) -> float:
        # TTL columns are kept in *ticks* internally; converted on return
        p = self.params
        return float(np.clip(p.default_ttl_ticks, p.min_ttl_ticks,
                             p.max_ttl_ticks))

    def resize(self, n: int) -> None:
        if n <= self.n:
            return
        grow = n - self.n
        self._coeff = np.concatenate([self._coeff, np.zeros(grow)])
        self._scratch = np.concatenate([self._scratch, np.zeros(grow)])
        self._hold_buf = np.zeros(n, dtype=bool)
        self.state.resize(n)
        super().resize(n)
        self._ttl_s_out = self._ttl * self.tick_s

    def set_exec(self, exec_s, tick_s):
        self.tick_s = float(tick_s)
        self._hold_thr = self.params.hold_min_rps * self.tick_s
        np.multiply(exec_s, self.params.headroom / self.tick_s,
                    out=self._coeff)
        np.multiply(self._ttl, self.tick_s, out=self._ttl_s_out)

    def tick(self, counts, has_arrivals):
        if not has_arrivals:
            # dormant fast-forward: no arrivals means the only state
            # movement is Holt decay — closed-form (holt_zero_matrix),
            # applied exactly when traffic resumes; decisions stay frozen
            # meanwhile (retirement still proceeds on the armed TTLs)
            self._zero_run += 1
            return self._desired, self._ttl_s_out
        if self._zero_run:
            self._catch_up(self._zero_run)
            self._zero_run = 0
        if _use_torch(self.n, self.backend):
            predictive_tick_torch(self.state, counts, self._coeff,
                                  self.params, self._desired, self._ttl,
                                  hold_thr=self._hold_thr)
            self.torch_ticks += 1
        else:
            predictive_tick_numpy(self.state, counts, self._coeff,
                                  self.params, True,
                                  self._desired, self._scratch, self._ttl,
                                  self._hold_buf, hold_thr=self._hold_thr)
        np.multiply(self._ttl, self.tick_s, out=self._ttl_s_out)
        return self._desired, self._ttl_s_out

    def _catch_up(self, k: int) -> None:
        s = self.state
        m00, m01, m10, m11 = holt_zero_matrix(self.params.alpha,
                                              self.params.beta, k)
        level = m00 * s.level + m01 * s.trend
        s.trend = m10 * s.level + m11 * s.trend
        s.level = level
        s.idle_ticks += float(k)


POLICY_KINDS: Dict[str, Type[KeepAlivePolicy]] = {
    cls.name: cls for cls in (FixedTTLPolicy, ScaleToZeroPolicy,
                              ConcurrencyTargetPolicy, PredictivePolicy)}


def make_policy(kind: str, **kwargs) -> KeepAlivePolicy:
    if kind not in POLICY_KINDS:
        raise KeyError(f"unknown keep-alive policy {kind!r}; "
                       f"known: {', '.join(sorted(POLICY_KINDS))}")
    cls = POLICY_KINDS[kind]
    if cls is not PredictivePolicy:
        kwargs.pop("backend", None)       # only the forecaster has one
    return cls(**kwargs)
