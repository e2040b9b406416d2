"""FDNInspector (paper §5): the benchmarking subsystem that turns
"benchmark the FDN" into data.

    from repro_torch.inspector import registry, run_scenario

    report = run_scenario(registry.get("mix/five-platform"))
    print(report.to_json())

``scenario`` — declarative Scenario spec + runner + versioned
ScenarioReport; ``traces`` — FaaS trace library (Azure minute counts,
diurnal / MMPP / ramp generators, WorkloadMix); ``streaming`` — chunked
columnar replay of Azure-scale traces in bounded memory; ``registry`` —
named scenarios: the paper's figures/tables re-expressed, plus mixes the
hand-wired benchmarks could not express.
"""
from repro_torch.inspector.scenario import (SCHEMA_VERSION, AutoscaleSpec,
                                            FaultEvent, Scenario,
                                            ScenarioReport, ScenarioRun,
                                            TracingSpec, Workload, assemble,
                                            build_report, run_scenario,
                                            run_scenario_state)
from repro_torch.inspector.streaming import StreamStats, stream_replay
from repro_torch.inspector.traces import (WorkloadMix, build_arrivals,
                                          counts_to_arrivals, diurnal_arrivals,
                                          load_azure_invocations_csv,
                                          mmpp_arrivals, ramp_arrivals,
                                          synthetic_azure_counts)
from repro_torch.inspector import registry

__all__ = [
    "SCHEMA_VERSION", "AutoscaleSpec", "FaultEvent", "Scenario",
    "ScenarioReport", "ScenarioRun", "TracingSpec", "Workload",
    "assemble", "build_report", "run_scenario", "run_scenario_state",
    "StreamStats", "stream_replay",
    "WorkloadMix", "build_arrivals", "counts_to_arrivals",
    "diurnal_arrivals", "load_azure_invocations_csv", "mmpp_arrivals",
    "ramp_arrivals", "synthetic_azure_counts", "registry",
]
