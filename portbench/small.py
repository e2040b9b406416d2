"""Small stand-ins of the benchmark's cells, for its CPU tests: the same
files with every size cut, so that a whole run takes seconds on a CPU."""
from __future__ import annotations

import copy

from portbench import harness

CUTS = {"hidden_size": 128, "intermediate_size": 256,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "num_hidden_layers": 2, "vocab_size": 512}
PROGRAM = {"d_model": 128, "d_ff": 256, "n_heads": 4, "n_kv_heads": 2,
           "num_layers": 2, "vocab_size": 512, "head_dim": 32}
MIX = {"slots": 4, "max_context": 256, "ramp_s": 0.3}
LENGTHS = {"prompt_tokens": (8, 200), "output_tokens": (4, 24)}


def config(name: str) -> dict:
    cfg = copy.deepcopy(harness.load(harness.HERE / "configs" /
                                     f"{name}.json"))
    cfg.update(CUTS)
    if "head_dim" in cfg:
        cfg["head_dim"] = 32
    replace = {**cfg["program"]["replace"], **PROGRAM}
    if cfg.get("num_local_experts"):
        cfg["num_local_experts"] = 4
        replace["n_experts"] = 4
    cfg["program"]["replace"] = replace
    return cfg


def mix(name: str) -> dict:
    m = copy.deepcopy(harness.load(harness.HERE / "mixes" / f"{name}.json"))
    m.update(MIX)
    if m["arrivals"] == "backlog":
        m["backlog"] = 2000
    for key, (lo, hi) in LENGTHS.items():
        spec = m[key]
        spec["min"], spec["max"] = lo, hi
        if "median" in spec:
            spec["median"] = (lo + hi) // 3
    return m


def files(workload: str, rate: float = 30.0) -> dict:
    """A cell of BENCHMARK.json with its files cut to CPU size."""
    f = harness.cell_files(workload)
    f["config"] = config(f["cell"]["config"])
    f["mix"] = mix(f["cell"]["traffic"])
    f["params"] = dict(f["params"])
    if f["mix"]["arrivals"] == "poisson":
        f["params"]["rate_per_s"] = rate
    return f
