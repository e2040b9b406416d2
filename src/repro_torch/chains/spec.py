"""Function-chain specification (paper §3.1.3 collaborative execution +
§5.1.4 data localization): an application modeled as a DAG of functions
with *typed data edges* — each edge names the object key and byte size
flowing between two stages — so placement can reason about data gravity
for the whole chain instead of one invocation at a time.

A ``Stage`` runs one deployed function (``fan_out`` parallel invocations
per chain instance, fan-in implied by multiple in-edges); a ``DataEdge``
either connects two stages (an *internal* intermediate object, written by
the producer's platform store and read by the consumer) or pulls an
*external* input (``src=EXTERNAL``) that pre-exists in some object store —
the anchor that gives a chain its data gravity.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Tuple

EXTERNAL = "__external__"


@dataclass(frozen=True)
class Stage:
    """One step of a chain: ``fan_out`` invocations of ``function``."""
    name: str
    function: str                    # deployed FunctionSpec name
    fan_out: int = 1                 # parallel invocations per instance
    slo_p90_s: Optional[float] = None  # per-stage SLO override


@dataclass(frozen=True)
class DataEdge:
    """A typed data dependency: ``size_bytes`` of object ``key`` flow from
    ``src`` (a stage name, or EXTERNAL for a pre-existing store object)
    into ``dst``."""
    src: str
    dst: str
    key: str
    size_bytes: float

    @property
    def external(self) -> bool:
        return self.src == EXTERNAL


@dataclass(frozen=True)
class Chain:
    """A DAG of stages joined by data edges (validated on construction)."""
    name: str
    stages: Tuple[Stage, ...]
    edges: Tuple[DataEdge, ...] = ()

    def __post_init__(self):
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"chain {self.name!r}: duplicate stage names")
        known = set(names)
        for e in self.edges:
            if e.dst not in known:
                raise ValueError(f"chain {self.name!r}: edge into unknown "
                                 f"stage {e.dst!r}")
            if not e.external and e.src not in known:
                raise ValueError(f"chain {self.name!r}: edge from unknown "
                                 f"stage {e.src!r}")
        self.topo_order()                  # raises on cycles

    # -------------------------------------------------------- structure ---
    @cached_property
    def _by_name(self) -> Dict[str, Stage]:
        return {s.name: s for s in self.stages}

    def stage(self, name: str) -> Stage:
        return self._by_name[name]

    @cached_property
    def _in_edges(self) -> Dict[str, Tuple[DataEdge, ...]]:
        out: Dict[str, List[DataEdge]] = {s.name: [] for s in self.stages}
        for e in self.edges:
            out[e.dst].append(e)
        return {k: tuple(v) for k, v in out.items()}

    @cached_property
    def _out_edges(self) -> Dict[str, Tuple[DataEdge, ...]]:
        out: Dict[str, List[DataEdge]] = {s.name: [] for s in self.stages}
        for e in self.edges:
            if not e.external:
                out[e.src].append(e)
        return {k: tuple(v) for k, v in out.items()}

    def in_edges(self, stage: str) -> Tuple[DataEdge, ...]:
        return self._in_edges[stage]

    def out_edges(self, stage: str) -> Tuple[DataEdge, ...]:
        return self._out_edges[stage]

    def preds(self, stage: str) -> Tuple[str, ...]:
        seen: List[str] = []
        for e in self._in_edges[stage]:
            if not e.external and e.src not in seen:
                seen.append(e.src)
        return tuple(seen)

    def succs(self, stage: str) -> Tuple[str, ...]:
        seen: List[str] = []
        for e in self._out_edges[stage]:
            if e.dst not in seen:
                seen.append(e.dst)
        return tuple(seen)

    def external_inputs(self) -> Tuple[DataEdge, ...]:
        return tuple(e for e in self.edges if e.external)

    def topo_order(self) -> Tuple[str, ...]:
        return self._topo

    @cached_property
    def _topo(self) -> Tuple[str, ...]:
        """Kahn's algorithm; deterministic (stage declaration order feeds
        the ready queue).  Raises ValueError on cycles."""
        indeg = {s.name: len(self.preds(s.name)) for s in self.stages}
        ready = [s.name for s in self.stages if indeg[s.name] == 0]
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m in self.succs(n):
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.stages):
            raise ValueError(f"chain {self.name!r}: cycle detected")
        return tuple(order)

    def sinks(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.stages
                     if not self.succs(s.name))

    @property
    def n_stages(self) -> int:
        return len(self.stages)
