"""Function Delivery Network (FDN) — the paper's contribution as a library.

Quick start:

    from repro_torch.core import FDNControlPlane, Gateway
    from repro_torch.core import profiles, functions, loadgen

    cp = FDNControlPlane()
    for prof in profiles.PAPER_PLATFORMS.values():
        cp.create_platform(prof)
    fns = functions.paper_functions()
    ...
"""
from repro_torch.core.types import (SLO, FunctionSpec, Invocation,
                                    PlatformProfile, DeploymentSpec)
from repro_torch.core.invocation_batch import InvocationBatch
from repro_torch.core.simulator import SimClock
from repro_torch.core.control_plane import (AccessControl, AdmissionRequest,
                                            FDNControlPlane)
from repro_torch.core.gateway import Gateway
from repro_torch.core.platform import TargetPlatform, ExecutionModel
from repro_torch.core.scheduler import (POLICIES, PerformanceRankedPolicy,
                                        UtilizationAwarePolicy,
                                        RoundRobinCollaboration,
                                        WeightedCollaboration,
                                        DataLocalityPolicy,
                                        EnergyAwarePolicy, SLOCompositePolicy,
                                        WarmAwarePolicy)
from repro_torch.core.sidecar import SidecarController
from repro_torch.core.monitoring import (ColumnarWindowSeries, MetricsRegistry,
                                         WindowSeries)
from repro_torch.core.behavioral import (P2Quantile, EWMA, EventModel,
                                         FunctionPerformanceModel, PerfState,
                                         compose_functions, composition_plan)
from repro_torch.core.knowledge_base import KnowledgeBase
from repro_torch.core.deployment import DeploymentGenerator
from repro_torch.core.data_placement import DataPlacementManager, ObjectStore
from repro_torch.core.energy import EnergyMeter
from repro_torch.core.faults import FailureDetector, Redeliverer, HedgePolicy
from repro_torch.core.qos import (AdmissionController, QosSpec,
                                  QOS_BATCH, QOS_LATENCY_CRITICAL, QOS_NAMES,
                                  QOS_STANDARD, qos_id)

__all__ = [
    "SLO", "FunctionSpec", "Invocation", "InvocationBatch",
    "PlatformProfile",
    "DeploymentSpec", "SimClock", "FDNControlPlane", "AccessControl",
    "AdmissionRequest", "AdmissionController", "QosSpec", "qos_id",
    "QOS_LATENCY_CRITICAL", "QOS_STANDARD", "QOS_BATCH", "QOS_NAMES",
    "Gateway", "TargetPlatform", "ExecutionModel", "POLICIES",
    "PerformanceRankedPolicy", "UtilizationAwarePolicy",
    "RoundRobinCollaboration", "WeightedCollaboration",
    "DataLocalityPolicy", "EnergyAwarePolicy", "SLOCompositePolicy",
    "WarmAwarePolicy",
    "SidecarController", "MetricsRegistry", "ColumnarWindowSeries",
    "WindowSeries", "P2Quantile", "EWMA",
    "EventModel", "FunctionPerformanceModel", "PerfState",
    "KnowledgeBase",
    "DeploymentGenerator", "DataPlacementManager", "ObjectStore",
    "EnergyMeter", "FailureDetector", "Redeliverer", "HedgePolicy",
    "compose_functions", "composition_plan",
]
