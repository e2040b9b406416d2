"""Whole runs of small cells on the CPU (the look for a card skipped): a
sound run is correct, and each fault a serving cell can have, planted
under the timed path, makes ``correct`` false. The command itself refuses
to run without a card, and without the program beside it."""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, small

CELLS = ("qwen3-0.6b.chat", "mixtral-8x7b-16l.chat", "qwen3-0.6b.offline")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def compare_all(monkeypatch):
    """Compare every finished request, so that a fault in any slot shows."""
    monkeypatch.setattr(harness, "SAMPLE_MAX", 10 ** 6)
    monkeypatch.setattr(harness, "SAMPLE_TOKENS", 10 ** 9)


def run(cell, seed=11, trace=False):
    return harness.run_cell(small.files(cell), seed, 1.0, trace, "cpu",
                            time.perf_counter())[0]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    bench = harness.load(harness.ROOT / "BENCHMARK.json")
    want = {m["name"] for m in harness.metrics_of(bench, cell, "end_to_end")}
    want.discard("joules_per_token")         # no energy counter on a CPU
    assert set(out["metrics"]) == want
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell,host_metric", [
    ("qwen3-0.6b.chat", "prefill_share.latency"),
    ("mixtral-8x7b-16l.chat", "prefill_share.itl_mean")])
def test_traced_run_gives_the_per_layer_metrics(cell, host_metric):
    out = run(cell, trace=True)
    assert out["correct"]
    assert list(out)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(out["device"])
    # the host ranges are read on the CPU too; device numbers are not
    assert host_metric in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def alter_tokens(api):
    plain = api.decode_step
    box = {"n": 0}

    def step(cfg, params, cache, batch):
        logits, cache = plain(cfg, params, cache, batch)
        box["n"] += 1
        if box["n"] % 4 == 0:          # every row's token, every 4th step
            logits = logits.clone()
            top = logits[:, 0].argmax(-1)
            rows = torch.arange(logits.shape[0])
            logits[rows, 0, (top + 1) % logits.shape[-1]] = 1e9
        return logits, cache
    return step


def state_unchanged(api):
    plain = api.decode_step

    def step(cfg, params, cache, batch):
        k, v = cache["k"].clone(), cache["v"].clone()
        logits, _ = plain(cfg, params, cache, batch)
        cache["k"].copy_(k)
        cache["v"].copy_(v)
        return logits, cache
    return step


def half_batch(api):
    plain = api.decode_step

    def step(cfg, params, cache, batch):
        logits, cache = plain(cfg, params, cache, batch)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0.0
        return logits, cache
    return step


@pytest.mark.parametrize("fault", [alter_tokens, state_unchanged,
                                   half_batch])
@pytest.mark.parametrize("cell", ["qwen3-0.6b.chat", "mixtral-8x7b-16l.chat"])
def test_a_fault_makes_the_run_incorrect(cell, fault, monkeypatch,
                                         compare_all):
    from repro_torch.models import model_api as api
    monkeypatch.setattr(api, "decode_step", fault(api))
    out = run(cell)
    assert not out["correct"], out["checks"]


def test_command_needs_a_card():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "qwen3-0.6b.chat", "--seed", "3", "--seconds",
                           "1", "--trace", "0"], cwd=harness.ROOT,
                          capture_output=True, text=True)
    assert proc.returncode != 0
    assert "needs 1 CUDA card" in proc.stderr
    assert not proc.stdout.strip()


def test_command_needs_the_program(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "qwen3-0.6b.chat", "--seed", "3", "--seconds",
                           "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True)
    assert proc.returncode != 0
    assert not any(line.startswith("{\"correct\"")
                   for line in proc.stdout.splitlines())


def test_a_tool_reads_beside_the_comparison():
    """``on_compare`` sees the compared requests; its value goes under
    ``readings``, before ``checks``."""
    seen = {}

    def on_compare(config, tree, picked, device):
        seen["n"] = len(picked)
        return {"n": len(picked)}

    out, served = harness.run_cell(small.files("qwen3-0.6b.chat"), 11, 1.0,
                                   False, "cpu", time.perf_counter(),
                                   on_compare=on_compare)
    assert out["readings"] == {"n": seen["n"]} and seen["n"] > 0
    assert list(out)[-2:] == ["readings", "checks"]
    assert served.window_due


def test_result_line_parses_as_json():
    out = run("qwen3-0.6b.offline")
    line = json.dumps(out)
    assert json.loads(line)["checks"]["max_logit_gap"]["limit"] > 0
