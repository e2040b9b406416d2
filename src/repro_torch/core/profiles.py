"""Target-platform profiles.

Part 1 — the paper's five platforms (Table 3), with power calibrated to
Table 4 (edge: Jetson POM_5V_CPU rails; HPC: RAPL PKG0/PKG1) and relative
speeds calibrated to Figures 5-7.

Part 2 — simulated TPU-pod platforms, copied as data from the JAX package's
profiles: the simulator's model of a target platform (its peak, memory rate
and link rate are the JAX package's v5e figures), forming the heterogeneous
FDN the serving examples schedule over. They describe simulated platforms,
not the hardware this port runs on.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.types import PlatformProfile

# ---------------------------------------------------------------------------
# Paper platforms (Table 3 / Table 4)
# ---------------------------------------------------------------------------

# Calibration anchor: JSON-loads @ 400 req/s for 600 s (Table 4):
#   edge  : power w/o load 0.445 W/node, with load ~1.47 W/node -> 2647 J
#   hpc   : 30.12 W/socket idle, 37.2 W/socket loaded (2 sockets)-> 44646 J
PAPER_PLATFORMS: Dict[str, PlatformProfile] = {
    "hpc-node-cluster": PlatformProfile(
        name="hpc-node-cluster", faas="openwhisk", nodes=1,
        replicas_per_node=44, memory_mb_per_node=754 * 1024,
        replica_flops=6.0e9, net_bw=10e9, overhead_s=0.08,
        idle_w_per_node=60.24, loaded_w_per_node=74.41,
        cold_start_s=2.5, prewarm_pool=2, scale_to_zero_s=300.0),
    "old-hpc-node-cluster": PlatformProfile(
        name="old-hpc-node-cluster", faas="openwhisk", nodes=1,
        replicas_per_node=40, memory_mb_per_node=251 * 1024,
        replica_flops=4.2e9, net_bw=10e9, overhead_s=0.09,
        idle_w_per_node=110.0, loaded_w_per_node=145.0,
        cold_start_s=2.5, prewarm_pool=2, scale_to_zero_s=300.0),
    "cloud-cluster": PlatformProfile(
        name="cloud-cluster", faas="openwhisk", nodes=3,
        replicas_per_node=4, memory_mb_per_node=8 * 1024,
        replica_flops=4.8e9, net_bw=1e9, overhead_s=0.10,
        idle_w_per_node=40.0, loaded_w_per_node=65.0,
        cold_start_s=2.5, prewarm_pool=1, scale_to_zero_s=300.0),
    "google-cloud-cluster": PlatformProfile(
        name="google-cloud-cluster", faas="gcf", nodes=1,
        replicas_per_node=100, memory_mb_per_node=1 << 20,
        replica_flops=0.45e9, net_bw=0.5e9, overhead_s=0.09,
        idle_w_per_node=50.0, loaded_w_per_node=90.0,
        cold_start_s=1.5, elastic=True, infra_metrics_visible=False,
        scale_to_zero_s=60.0, region="us-east"),
    "edge-cluster": PlatformProfile(
        name="edge-cluster", faas="openfaas", nodes=3,
        replicas_per_node=4, memory_mb_per_node=4 * 1024,
        replica_flops=0.55e9, net_bw=0.2e9, overhead_s=0.28,
        idle_w_per_node=0.445, loaded_w_per_node=1.471,
        cold_start_s=4.0, scale_to_zero_s=120.0, arm=True),
}

# ---------------------------------------------------------------------------
# Simulated TPU-pod platforms (data, as in the JAX package)
# ---------------------------------------------------------------------------

V5E_PEAK = 197e12
V5E_HBM = 819e9
V5E_LINK = 50e9


def _pod(name: str, chips: int, faas: str = "openwhisk",
         peak: float = V5E_PEAK, power_per_chip: float = 180.0,
         idle_frac: float = 0.35, **kw) -> PlatformProfile:
    return PlatformProfile(
        name=name, faas=faas, nodes=chips, replicas_per_node=1,
        memory_mb_per_node=16 * 1024,
        replica_flops=peak * 0.4,            # effective per-chip FLOP/s
        net_bw=100e9, chips=chips, peak_flops=peak, hbm_bw=V5E_HBM,
        link_bw=V5E_LINK, idle_w_per_node=power_per_chip * idle_frac,
        loaded_w_per_node=power_per_chip, cold_start_s=30.0,
        prewarm_pool=1, scale_to_zero_s=600.0, **kw)


TPU_PLATFORMS: Dict[str, PlatformProfile] = {
    # full v5e pod slice — the "hpc-node-cluster" analogue
    "hpc-pod": _pod("hpc-pod", 256),
    # previous-gen pod — lower peak, worse perf/W ("old-hpc" analogue)
    "old-pod": _pod("old-pod", 128, peak=0.55 * V5E_PEAK,
                    power_per_chip=220.0),
    # small cloud slice
    "cloud-pod": _pod("cloud-pod", 16, power_per_chip=190.0),
    # opaque autoscaled public endpoint ("google-cloud-cluster" analogue)
    "public-cloud": _pod("public-cloud", 64, faas="gcf",
                         elastic=True, infra_metrics_visible=False),
    # low-power edge inference box ("edge-cluster" analogue)
    "edge-tpu": _pod("edge-tpu", 4, faas="tinyfaas",
                     peak=0.12 * V5E_PEAK, power_per_chip=18.0,
                     idle_frac=0.2),
}


def paper_profile(name: str) -> PlatformProfile:
    return PAPER_PLATFORMS[name]


def tpu_profile(name: str) -> PlatformProfile:
    return TPU_PLATFORMS[name]
