"""Chain catalog: named multi-stage applications for the FDNInspector.

A ``ChainTemplate`` bundles the DAG with the stage functions it needs
deployed and the external input objects that give it data gravity (each
input may pin a location — the paper's "data lives somewhere" premise —
or default to the scenario's ``data_location``).

Templates:

  ``etl-pipeline``          extract -> transform (fan-out 4) -> aggregate
                            -> load; a linear ETL with one wide stage.
  ``ml-preprocess-serve``   image preprocess -> model serve -> respond,
                            built from the paper's Table-2 functions.
  ``ab-dual-source``        two gravity anchors (a 48 MB source pinned to
                            one platform, a small source pinned to
                            another) feeding a fan-in join — the chain the
                            split-vs-colocate A/B scenarios measure.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.chains.spec import EXTERNAL, Chain, DataEdge, Stage
from repro_torch.core.types import SLO, FunctionSpec


@dataclass(frozen=True)
class ChainInput:
    """One external object a chain reads: seeded before the run."""
    key: str
    size_bytes: float
    location: Optional[str] = None     # None -> scenario data_location


@dataclass(frozen=True)
class ChainTemplate:
    chain: Chain
    functions: Dict[str, FunctionSpec] = field(default_factory=dict)
    inputs: Tuple[ChainInput, ...] = ()


_FACTORIES: Dict[str, Callable[[], ChainTemplate]] = {}


def register(name: str, factory: Callable[[], ChainTemplate]) -> None:
    _FACTORIES[name] = factory


def names() -> List[str]:
    return sorted(_FACTORIES)


def get(name: str) -> ChainTemplate:
    if name not in _FACTORIES:
        raise KeyError(f"unknown chain {name!r}; "
                       f"registered: {', '.join(names())}")
    return _FACTORIES[name]()


# ---------------------------------------------------------------------------
# etl-pipeline
# ---------------------------------------------------------------------------

def etl_pipeline() -> ChainTemplate:
    fns = {
        "chain-extract": FunctionSpec(
            name="chain-extract", flops=4e8, read_bytes=8e6,
            write_bytes=6e6, memory_mb=256, slo=SLO(5.0)),
        "chain-transform": FunctionSpec(
            name="chain-transform", flops=2e9, read_bytes=6e6,
            write_bytes=5e5, memory_mb=512, slo=SLO(10.0)),
        "chain-aggregate": FunctionSpec(
            name="chain-aggregate", flops=5e8, read_bytes=2e6,
            write_bytes=5e5, memory_mb=256, slo=SLO(5.0)),
        "chain-load": FunctionSpec(
            name="chain-load", flops=2e7, read_bytes=5e5,
            write_bytes=1e5, memory_mb=128, slo=SLO(2.0)),
    }
    chain = Chain(
        name="etl-pipeline",
        stages=(Stage("extract", "chain-extract"),
                Stage("transform", "chain-transform", fan_out=4),
                Stage("aggregate", "chain-aggregate"),
                Stage("load", "chain-load")),
        edges=(DataEdge(EXTERNAL, "extract", "chains/etl/source", 8e6),
               DataEdge("extract", "transform", "records", 6e6),
               DataEdge("transform", "aggregate", "features", 2e6),
               DataEdge("aggregate", "load", "summary", 5e5)))
    return ChainTemplate(chain, fns,
                         (ChainInput("chains/etl/source", 8e6),))


# ---------------------------------------------------------------------------
# ml-preprocess-serve (reuses the paper's Table-2 functions as stages)
# ---------------------------------------------------------------------------

def ml_preprocess_serve() -> ChainTemplate:
    chain = Chain(
        name="ml-preprocess-serve",
        stages=(Stage("preprocess", "image-processing"),
                Stage("serve", "sentiment-analysis", fan_out=2,
                      slo_p90_s=8.0),
                Stage("respond", "JSON-loads")),
        edges=(DataEdge(EXTERNAL, "preprocess", "images/sample.jpg", 2e6),
               DataEdge("preprocess", "serve", "tensors", 3e6),
               DataEdge("serve", "respond", "scores", 1e5)))
    # stage functions are the already-deployed paper functions; only the
    # image input is (re)declared so standalone harnesses can seed it
    return ChainTemplate(chain, {},
                         (ChainInput("images/sample.jpg", 2e6),))


# ---------------------------------------------------------------------------
# ab-dual-source (split-vs-colocate A/B)
# ---------------------------------------------------------------------------

AB_BIG_HOME = "cloud-cluster"
AB_SMALL_HOME = "old-hpc-node-cluster"


def ab_dual_source() -> ChainTemplate:
    """Two data-gravity anchors: a 48 MB source pinned to the cloud
    cluster and a small source pinned to the old HPC cluster, feeding a
    fan-in join.  The shard stage is I/O-bound (prefers the old HPC's
    10 Gb/s store path), the join/report are compute-bound (prefer the
    cloud's faster replicas) — so a compute-greedy split lands the shard
    work off the colocation platform and the WAN price of that choice is
    exactly the 16 MB of shard features crossing platforms."""
    fns = {
        "chain-extract-big": FunctionSpec(
            name="chain-extract-big", flops=2e8, read_bytes=48e6,
            write_bytes=8e6, memory_mb=512, slo=SLO(20.0)),
        "chain-shard": FunctionSpec(
            name="chain-shard", flops=1e9, read_bytes=60e6,
            write_bytes=4e6, memory_mb=512, slo=SLO(20.0)),
        "chain-join": FunctionSpec(
            name="chain-join", flops=3e9, read_bytes=20e6,
            write_bytes=1e6, memory_mb=512, slo=SLO(20.0)),
        "chain-report": FunctionSpec(
            name="chain-report", flops=5e7, read_bytes=1e6,
            write_bytes=1e4, memory_mb=128, slo=SLO(20.0)),
    }
    chain = Chain(
        name="ab-dual-source",
        stages=(Stage("extract-big", "chain-extract-big"),
                Stage("shard", "chain-shard", fan_out=4),
                Stage("join", "chain-join"),
                Stage("report", "chain-report")),
        edges=(DataEdge(EXTERNAL, "extract-big", "chains/ab/big-source",
                        48e6),
               DataEdge(EXTERNAL, "shard", "chains/ab/small-source", 4e6),
               DataEdge("extract-big", "join", "big-features", 8e6),
               DataEdge("shard", "join", "small-features", 16e6),
               DataEdge("join", "report", "joined", 1e6)))
    return ChainTemplate(
        chain, fns,
        (ChainInput("chains/ab/big-source", 48e6, AB_BIG_HOME),
         ChainInput("chains/ab/small-source", 4e6, AB_SMALL_HOME)))


register("etl-pipeline", etl_pipeline)
register("ml-preprocess-serve", ml_preprocess_serve)
register("ab-dual-source", ab_dual_source)
