"""One run of one cell: set-up, the window, the comparison that decides
``correct``, and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file found by its name in ``BENCHMARK.json``:

* ``configs/<config>.json``: the published configuration as it is run,
  with ``program`` naming the program's configuration and what is replaced
  in it;
* ``mixes/<traffic>.json``: the mix's parameters (``traffic.py``);
* ``cells/<workload>.json``: the cell's offered rate (``rate_per_s``) and
  the limits of the numbers compared (``limits``);
* ``readers/<metric>.py``, or ``readers/<name up to its first '.'>.py``
  for a quantity split by the end-to-end metric it moves
  (``decode_mfu.latency``, ``decode_mfu.offline``): ``read(run)`` gives the
  metric's value, or None where there is nothing to read.
"""
from __future__ import annotations

import importlib.util
import inspect
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import loop, reference, traffic, weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the traced part of a --trace 1 window, seconds from its opening
TRACE_S = 6.0
# the comparison's sample: the longest finished request, then others drawn
# from the seed until SAMPLE_TOKENS served tokens or SAMPLE_MAX requests
SAMPLE_TOKENS = 1024
SAMPLE_MAX = 12


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_files(name: str, root: Path = ROOT) -> dict:
    """The entries and files of workload ``name``."""
    bench = load(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {"bench": bench, "cell": cell,
            "config": load(root / conf["file"]),
            "mix": load(HERE / "mixes" / f"{cell['traffic']}.json"),
            "params": load(HERE / "cells" / f"{name}.json")}


def metrics_of(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The cell's metrics of one kind ("end_to_end" or "per_layer")."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


# ------------------------------------------------------------- program ---
# published key -> the program's configuration field
WIDTHS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
          "num_attention_heads": "n_heads", "num_key_value_heads":
          "n_kv_heads", "num_hidden_layers": "num_layers",
          "vocab_size": "vocab_size", "num_local_experts": "n_experts",
          "num_experts_per_tok": "top_k", "rope_theta": "rope_theta",
          "tie_word_embeddings": "tie_embeddings"}


def program_config(config: dict):
    """The program's configuration for a configuration file, with the
    kernels on, checked against every size the file states, its RMSNorm
    epsilon (the program's one epsilon, ``layers.rmsnorm``'s default; no
    field of its configuration sets it), and, with experts, a capacity at
    which no choice can drop, as in the published models."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers

    prog = config["program"]
    pcfg = get_config(prog["arch"]).replace(**prog.get("replace", {}),
                                            use_pallas=True)
    dm = weights.dims(config)
    want = {k: config[k] for k in WIDTHS if k in config}
    got = {k: getattr(pcfg, v) for k, v in WIDTHS.items() if k in config}
    want["head_dim"], got["head_dim"] = dm["D"], pcfg.head_dim
    want["qk_norm"], got["qk_norm"] = dm["qk_norm"], pcfg.qk_norm
    want["rms_norm_eps"] = config["rms_norm_eps"]
    got["rms_norm_eps"] = inspect.signature(
        layers.rmsnorm).parameters["eps"].default
    if pcfg.n_experts:
        # an expert holds group * top_k * capacity_factor / n_experts
        # choices; from capacity_factor * top_k >= n_experts on, that is the
        # whole group, and a token chooses an expert at most once
        want["drops_nothing"] = True
        got["drops_nothing"] = \
            pcfg.capacity_factor * pcfg.top_k >= pcfg.n_experts
    bad = {k: (want[k], got[k]) for k in want if want[k] != got[k]}
    if bad:
        raise ValueError(f"the program's {prog['arch']} does not run "
                         f"{config['name']} as its file states: "
                         f"(file, program) {bad}")
    return pcfg


# ----------------------------------------------------------- correctness --
def sample(served: loop.Served, seed: int) -> List[loop.Track]:
    done = [t for t in served.tracks if t.req is not None and t.req.done]
    if not done:
        return []
    done.sort(key=lambda t: (-len(t.req.out_tokens), -len(t.due.prompt),
                             t.due.rid))
    picked, rest = [done[0]], done[1:]
    order = traffic.rng_for(seed, 2).permutation(len(rest))
    tokens = len(done[0].req.out_tokens)
    for i in order:
        if tokens >= SAMPLE_TOKENS or len(picked) >= SAMPLE_MAX:
            break
        picked.append(rest[i])
        tokens += len(rest[i].req.out_tokens)
    return picked


def inputs(picked: List[loop.Track], device):
    """The reference's inputs for the picked requests: each prompt with its
    served tokens but the last, the prompt lengths, and the served
    tokens."""
    seqs, n_prompts, served = [], [], []
    for t in picked:
        out = np.asarray(t.req.out_tokens, dtype=np.int64)
        seq = np.concatenate([t.due.prompt.astype(np.int64), out[:-1]])
        seqs.append(torch.from_numpy(seq).to(device))
        n_prompts.append(len(t.due.prompt))
        served.append(torch.from_numpy(out).to(device))
    return seqs, n_prompts, served


def compare(config: dict, tree: dict, picked: List[loop.Track],
            limits: dict, device) -> Dict[str, float]:
    """The reference's f32 logits over each picked request's prompt and
    served tokens; the widest and the mean gap by which a served token lies
    below the reference's best, at the positions whose routing is no near
    tie (each layer's k-th choice ahead of the next by
    ``limits["route_margin"]``; every position of a model without
    experts)."""
    seqs, n_prompts, served = inputs(picked, device)
    ref = reference.Reference(config, tree)
    tau = limits.get("route_margin", 0.0)
    gaps = [reference.served_gaps(lg, s, m, tau) for lg, s, m in
            zip(ref.logits(seqs, n_prompts), served, ref.margins)]
    return {**reference.gap_numbers(gaps),
            "served_tokens": sum(len(s) for s in served)}


# ------------------------------------------------------------------ run --
class Run:
    """What a metric's reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def read_metric(name: str, run: Run) -> Optional[float]:
    path = HERE / "readers" / f"{name}.py"
    if not path.exists():
        path = HERE / "readers" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def info(**kw):
    print(json.dumps({"info": kw}), flush=True)


def run_cell(files: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float,
             on_compare: Optional[Callable] = None):
    """One run on ``device``: the result line's object, and what was served
    (``loop.Served``). ``on_compare(config, tree, picked, device)``, where
    given, is called beside the comparison and its value kept under the
    result's ``readings`` (tools only; the benchmark passes none)."""
    from repro_torch.serving.engine import Request, ServingEngine

    bench, cell, config, mix, params = (files[k] for k in (
        "bench", "cell", "config", "mix", "params"))
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    pcfg = program_config(config)
    tree = weights.make(config, seed, dev)
    engine = ServingEngine(pcfg, tree, batch_size=mix["slots"],
                           max_context=mix["max_context"])
    sched = traffic.schedule(mix, seed, config["vocab_size"],
                             params.get("rate_per_s", 0.0), seconds)

    # warm-up: one prefill at every bucket the mix reaches, each followed
    # by a decode step
    lo = min(len(d.prompt) for d in sched)
    hi = max(len(d.prompt) for d in sched)
    warm = traffic.rng_for(seed, 3)
    for b in engine.buckets:
        if engine._bucket_len(lo) <= b <= engine._bucket_len(hi):
            engine.submit(Request(-1, warm.integers(
                0, config["vocab_size"], min(b, hi), dtype=np.int32), 2))
            while engine.queue or any(s is not None for s in engine.slots):
                engine.step()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    counter = None
    if on_card:
        from portbench.energy import Counter, pci_bus_id
        counter = Counter(pci_bus_id(torch.cuda.get_device_properties(dev)))
    prof_box = {}

    def on_open():
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.start()
            prof_box.update(prof=prof, t0=time.perf_counter())
        return {"energy_j": counter.read() if counter else None,
                "t": time.perf_counter()}

    def on_close():
        return {"energy_j": counter.read() if counter else None,
                "queue": len(engine.queue)}

    def on_tick(now):
        prof = prof_box.get("prof")
        if prof is not None and "t1" not in prof_box \
                and now >= prof_box["t0"] + min(TRACE_S, seconds):
            if on_card:
                torch.cuda.synchronize(dev)
            prof.stop()
            prof_box["t1"] = time.perf_counter()

    hooks = {"open": on_open, "close": on_close, "tick": on_tick,
             "loop": lambda: torch.profiler.record_function("harness.loop")}
    served = loop.serve(
        engine, lambda d: Request(d.rid, d.prompt, d.max_new_tokens),
        sched, mix["ramp_s"], seconds, hooks)
    if "t1" not in prof_box and "prof" in prof_box:
        prof_box["prof"].stop()
        prof_box["t1"] = time.perf_counter()
    setup_s = served.open_t - t_start
    if mix["arrivals"] == "backlog" and served.hooks["close"]["queue"] == 0:
        raise RuntimeError("the backlog ran dry inside the window: the mix's "
                           "backlog is too small for this program")
    e0, e1 = (served.hooks["open"]["energy_j"],
              served.hooks["close"]["energy_j"])
    late = loop.lateness_s(served)
    info(requests=len(served.tracks), due_in_window=len(served.window_due),
         drained=served.drained, steps=len(served.steps),
         late_p50_ms=float(np.median(late) * 1e3) if len(late) else None,
         late_max_ms=float(late.max() * 1e3) if len(late) else None,
         engine=engine.stats())
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    name_of_card = torch.cuda.get_device_name(dev) if on_card else "cpu"

    tr = None
    if trace:
        from portbench.trace import collect
        tr = collect(prof_box["prof"])
        info(trace_events=tr.extra, traced_s=prof_box["t1"] - prof_box["t0"])
    traced_steps = [s for s in served.steps if "t0" in prof_box
                    and s.t0 >= prof_box["t0"] and s.t1 <= prof_box["t1"]]
    run = Run(config=config, mix=mix, params=params, served=served,
              setup_s=setup_s, energy_j=(e1 - e0) if e0 is not None
              and e1 is not None else None, trace=tr,
              traced_steps=traced_steps)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, cell["name"], kind):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the comparison, once the window has closed and the program's state
    # is freed
    picked = sample(served, seed)
    del engine
    if on_card:
        torch.cuda.empty_cache()
    limits = params["limits"]
    checks = {}
    if picked:
        got = compare(config, tree, picked, limits, dev)
        info(compared_requests=len(picked), **got)
        checks = {k: {"value": got[k], "limit": limits[k]}
                  for k in ("max_logit_gap", "mean_logit_gap")
                  if k in limits}
    correct = bool(checks) and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    attempted = len({id(t) for t in served.window_due} | {
        id(t) for t in served.tracks
        if any(served.open_t < s <= served.close_t for s in t.stamps)})
    failed = sum(1 for t in served.window_due if not t.stamps)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": name_of_card, "count": 1,
                   "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if on_compare is not None and picked:
        out["readings"] = on_compare(config, tree, picked, dev)
    if tr is not None:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s()
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps":
                            tr.idle_gaps()}
    out["checks"] = checks
    if counter is not None:
        counter.close()
    return out, served


def checks_text(out: dict) -> str:
    lines = [f"{k}: {v['value']!r} (limit {v['limit']!r})"
             for k, v in out["checks"].items()]
    return "\n".join(lines) if lines else "no request finished: nothing " \
        "compared"
