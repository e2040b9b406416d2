"""Core FDN datatypes: functions, invocations, SLOs, platform profiles,
deployment specifications.

Terminology follows the paper: a *function* is deployed onto one or more
*target platforms* (homogeneous cluster + FaaS platform); an *invocation* is
one request; the FDN *delivers* each invocation to the right platform.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

_inv_counter = itertools.count()


@dataclass(frozen=True)
class SLO:
    """Service Level Objective (paper §5.1: P90 response time)."""
    p90_response_s: float = 7.0
    max_error_rate: float = 0.01


@dataclass(frozen=True)
class FunctionSpec:
    """A deployable function: a torch workload plus its resource demands.

    ``flops``/``read_bytes``/``write_bytes`` describe one invocation;
    ``memory_mb`` is the per-replica footprint; ``data_objects`` the object
    store keys read (drives data-locality scheduling, §5.1.4).
    """
    name: str
    flops: float = 1e6
    read_bytes: float = 0.0
    write_bytes: float = 0.0
    memory_mb: int = 256
    runtime: str = "python3"
    data_objects: Tuple[str, ...] = ()
    # Optional real torch callable: (object_store_payloads) -> result,
    # returning with its device work done.
    real_fn: Optional[Callable[..., Any]] = None
    # ML-serving functions: which arch config this function serves.
    arch: Optional[str] = None
    kind: str = "generic"            # generic | serve | train
    slo: SLO = SLO()

    def replace(self, **kw) -> "FunctionSpec":
        return dataclasses.replace(self, **kw)


class Invocation:
    """One request, with its full lifecycle for metric derivation."""

    __slots__ = ("id", "fn", "arrival_t", "vu", "args", "platform",
                 "scheduled_t", "start_t", "end_t", "status", "cold_start",
                 "exec_time", "data_time", "queue_time", "hedged_from",
                 "attempts", "arrival_recorded", "qos", "tenant",
                 "decision", "_on_done")

    def __init__(self, fn: FunctionSpec, arrival_t: float, vu: int = 0,
                 args: Any = None, qos: int = 1, tenant: int = 0):
        self.id = next(_inv_counter)
        self.fn = fn
        self.arrival_t = arrival_t
        self.vu = vu
        self.args = args
        # QoS class (repro_torch.core.qos ids; 1 == standard) and tenant —
        # literal defaults keep this module import-independent of qos
        self.qos = qos
        self.tenant = tenant
        self.platform: Optional[str] = None
        self.scheduled_t: Optional[float] = None
        self.start_t: Optional[float] = None
        self.end_t: Optional[float] = None
        self.status = "pending"       # pending|queued|running|done|failed
        self.cold_start = False
        self.exec_time = 0.0
        self.data_time = 0.0
        self.queue_time = 0.0
        self.hedged_from: Optional[int] = None
        self.attempts = 0
        # decision-journal row id that routed this invocation (-1 when
        # provenance is off or the row bypassed the journaled fast path:
        # overrides, spillover, hedges, stateful policies)
        self.decision = -1
        # arrival recorded in the behavioral models exactly once, even if
        # the invocation is redelivered through submit() again
        self.arrival_recorded = False
        self._on_done: Optional[Callable[[], None]] = None

    @property
    def response_time(self) -> Optional[float]:
        if self.end_t is None:
            return None
        return self.end_t - self.arrival_t

    def __repr__(self):
        return (f"<Inv {self.id} {self.fn.name} @{self.arrival_t:.2f} "
                f"{self.status} on {self.platform}>")


@dataclass(frozen=True)
class PlatformProfile:
    """Hardware + FaaS-platform profile of one target platform.

    The paper's five CPU platforms and this framework's TPU pod profiles are
    both expressed with this type; compute speed enters through
    ``replica_flops`` (per-replica effective FLOP/s) and the roofline terms
    through ``peak_flops``/``hbm_bw``/``link_bw`` for pod-scale functions.
    """
    name: str
    faas: str                         # openwhisk | openfaas | gcf | tinyfaas
    nodes: int = 1
    replicas_per_node: int = 4        # concurrency slots (cores / chips)
    memory_mb_per_node: int = 8192
    replica_flops: float = 2e9        # effective FLOP/s per busy replica
    net_bw: float = 1e9               # bytes/s to/from object stores
    # pod-scale terms (TPU platforms; CPU platforms keep defaults)
    chips: int = 0
    peak_flops: float = 0.0
    hbm_bw: float = 0.0
    link_bw: float = 0.0
    # power model: P = idle + (loaded - idle) * utilization  (per node)
    idle_w_per_node: float = 5.0
    loaded_w_per_node: float = 20.0
    # keep-alive watts per *idle* warm replica (container resident in
    # memory): the energy price of avoiding cold starts.  0 keeps the
    # historical accounting (idle pools are free) for platforms that do
    # not opt in; the autoscale scenarios set it explicitly.
    warm_w_per_replica: float = 0.0
    # FaaS semantics
    overhead_s: float = 0.05          # gateway/controller/watchdog per req
    cold_start_s: float = 2.0
    prewarm_pool: int = 0             # openwhisk prewarm containers
    scale_to_zero_s: float = 120.0    # faas-idler inactivity window
    elastic: bool = False             # gcf-style unbounded replicas
    infra_metrics_visible: bool = True
    arm: bool = False                 # edge platforms: need ARM images
    region: str = "local"

    @property
    def total_replicas(self) -> int:
        return self.nodes * self.replicas_per_node

    @property
    def total_memory_mb(self) -> int:
        return self.nodes * self.memory_mb_per_node


@dataclass
class DeploymentSpec:
    """User-provided configuration specification (paper Fig. 3/Listing 1),
    annotated by the DeploymentGenerator."""
    test_name: str
    functions: List[FunctionSpec]
    target_platforms: List[str]
    test_instances: Dict[str, Dict] = field(default_factory=dict)
    annotations: Dict[str, Dict] = field(default_factory=dict)
