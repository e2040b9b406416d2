"""Predictive autoscaling: warm-pool lifecycle, keep-alive policies, and
energy-aware prewarming (the replica-lifecycle control loop where the
FDN's SLO and energy objectives collide — keeping replicas warm burns
idle watts, letting them die costs cold starts).

  * ``WarmPoolController``  — per-(function, platform) control loop
    ticked on the SimClock (controller.py);
  * keep-alive policies     — fixed TTL, scale-to-zero, reactive
    concurrency target, predictive prewarmer (policies.py);
  * arrival forecasting     — columnar Holt-linear + inter-arrival-gap
    histogram, NumPy reference + torch backend on the forecast device
    (forecast.py, ``repro_torch.kernels.warm_forecast``).
"""
from repro_torch.autoscale.controller import WarmPoolController
from repro_torch.autoscale.forecast import (ForecastParams, ForecastState,
                                            forecast_settings,
                                            get_forecast_backend,
                                            get_forecast_device,
                                            set_forecast_backend,
                                            set_forecast_device)
from repro_torch.autoscale.policies import (POLICY_KINDS,
                                            ConcurrencyTargetPolicy,
                                            FixedTTLPolicy, KeepAlivePolicy,
                                            PredictivePolicy,
                                            ScaleToZeroPolicy, make_policy)

__all__ = [
    "WarmPoolController", "KeepAlivePolicy", "FixedTTLPolicy",
    "ScaleToZeroPolicy", "ConcurrencyTargetPolicy", "PredictivePolicy",
    "ForecastParams", "ForecastState", "POLICY_KINDS", "make_policy",
    "set_forecast_backend", "get_forecast_backend", "set_forecast_device",
    "get_forecast_device", "forecast_settings",
]
