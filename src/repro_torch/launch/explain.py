"""Why each platform: run one registry scenario with the decision journal
(or, with ``--trace``, the flight recorder) attached, as the ``explain``
and ``trace`` commands of ``benchmarks/run.py`` of the JAX package run it.

    PYTHONPATH=src python -m repro_torch.launch.explain <scenario> \\
        [--whatif policy=NAME[,key=val...]] [--journal PATH] [--out PATH] \\
        [--backend numpy|torch|auto] [--kernel] [--device D]
    PYTHONPATH=src python -m repro_torch.launch.explain --trace <scenario> \\
        [--sample S] [--out PATH] [--device D]

Explain: the journal's ``decision_provenance`` section, the same-policy
replay oracle (re-scoring the journaled feature columns under the
journaled policy must reproduce every choice byte for byte), and with
``--whatif`` the counterfactual summary under another policy config;
``--journal`` saves the journal, ``--out`` the printed JSON. The exit code
is 1 when the replay oracle fails.

Trace: the scenario with the flight recorder attached; prints the
``latency_breakdown`` section and, with ``--out``, writes a Chrome
trace-event JSON (load it in Perfetto / chrome://tracing) with the
telemetry alerts as annotations.

``--backend`` picks the decision backend (the journal records whichever
backend decided), ``--kernel`` routes the torch backend's composite
decision through the CUDA kernel K1, and ``--device`` is where the torch
backends, the function bodies and the store objects live: the CUDA card
unless ``cpu`` is asked for; without a card the run stops with an error
naming it.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from repro_torch.autoscale import forecast
from repro_torch.core import scheduler as sched
from repro_torch.device import NoCudaDevice, resolve
from repro_torch.inspector import registry, run_scenario_state
from repro_torch.obs import (WhatIfConfig, replay, whatif_section,
                             write_chrome_trace)


def explain(sc, whatif: Optional[WhatIfConfig] = None,
            journal_path: Optional[str] = None, device=None) -> dict:
    """The explain payload of one scenario run with the journal on."""
    state = run_scenario_state(sc.replace(provenance=True), device)
    journal = state.control_plane.journal
    payload = {"scenario": sc.name,
               "decision_provenance": state.report.decision_provenance,
               "replay_oracle": True}
    if journal.n:
        base = replay(journal)
        payload["replay_oracle"] = bool(base.matches(journal))
        if whatif is not None:
            payload["whatif"] = whatif_section(journal, base,
                                               replay(journal, whatif))
    if journal_path is not None:
        journal.save(journal_path)
    payload["journal_rows"] = journal.n
    return payload


def trace(sc, sample: float = 1.0, out_path: Optional[str] = None,
          device=None) -> dict:
    """The latency_breakdown of one scenario run with the recorder on;
    writes the Chrome trace to ``out_path`` when given."""
    state = run_scenario_state(sc.replace(trace=True, trace_sample=sample),
                               device)
    n_events = None
    if out_path is not None:
        n_events = write_chrome_trace(state.control_plane.recorder,
                                      out_path, alerts=state.report.alerts)
    return {"scenario": sc.name, "trace_events": n_events,
            "latency_breakdown": state.report.latency_breakdown}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name")
    ap.add_argument("--trace", action="store_true",
                    help="flight recorder instead of the decision journal")
    ap.add_argument("--whatif", default=None, type=WhatIfConfig.parse,
                    help="policy=NAME[,key=val...]")
    ap.add_argument("--journal", default=None, help="save the journal here")
    ap.add_argument("--sample", default=1.0, type=float,
                    help="trace sampling fraction")
    ap.add_argument("--out", default=None)
    ap.add_argument("--backend", choices=("numpy", "torch", "auto"),
                    default="auto")
    ap.add_argument("--kernel", action="store_true",
                    help="composite decision through the CUDA kernel K1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.name not in registry.names():
        prefix = "trace/" if args.trace else "prov/"
        print(f"unknown scenario {args.name!r}; any registered scenario "
              f"works, and these arms come pre-configured:")
        for name in registry.names():
            if name.startswith(prefix):
                print(f"  {name}")
        return 1
    try:
        dev = resolve(args.device)
    except NoCudaDevice as exc:
        print(f"explain: {exc}", file=sys.stderr)
        return 2
    sc = registry.get(args.name)
    with sched.score_settings(args.backend, dev, args.kernel), \
            forecast.forecast_settings(forecast.get_forecast_backend(), dev):
        if args.trace:
            payload = trace(sc, args.sample, args.out, dev)
            print(json.dumps(payload, indent=2, sort_keys=True))
            return 0
        payload = explain(sc, args.whatif, args.journal, dev)
    text = json.dumps(payload, indent=2, sort_keys=True)
    if args.out is not None:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if not payload["replay_oracle"]:
        print("# REPLAY ORACLE FAILED: same-policy replay diverged from the "
              "journaled choices", file=sys.stderr)
    print(text)
    return 0 if payload["replay_oracle"] else 1


if __name__ == "__main__":
    sys.exit(main())
