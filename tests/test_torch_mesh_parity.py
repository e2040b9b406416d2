"""``launch/mesh_parity.py`` on the CPU at reduced size: the train step on
a (1, 1) mesh over a world of one (gloo) is bit-equal to the meshless step
in every variant, and the state bounds of ``leaf_diffs`` (the check of
chip_smoke.py's ``[mesh]`` phase) reject two wrong gradients. The CLI runs
in a subprocess of its own: it starts a process group."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import mesh_parity as mp

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("meshless_again", "mesh", "mesh_no_contiguous_grad",
            "mesh_no_local_shards", "wrong_other_batch", "wrong_first_row")


@pytest.fixture(scope="module")
def lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mesh_parity", "--device",
         "cpu", "--reduced", "--seq", "32", "--batch", "2", "--variants",
         ",".join(VARIANTS)], capture_output=True, text=True, env=env,
        timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = [json.loads(l) for l in proc.stdout.splitlines()
           if l.startswith("{")]
    return {d["variant"]: d for d in out}


@pytest.mark.parametrize("variant", VARIANTS[:4])
def test_mesh_variants_are_bit_equal_to_the_meshless_step(lines, variant):
    d = lines[variant]
    assert "0:meshless" in d["bit_equal_to"], d
    assert d["leaves_bit_equal"] == d["leaves"] and d["ok"]
    assert d["loss"] == lines["meshless"]["loss"]


@pytest.mark.parametrize("variant", VARIANTS[4:])
def test_state_bounds_reject_a_wrong_gradient(lines, variant):
    d = lines[variant]
    assert not d["bit_equal_to"] and not d["ok"]
    for part in ("m", "v"):
        assert d[f"{part}_share_within_tight"] < mp.STATE_TIGHT_SHARE


def test_leaf_diffs_reads_the_state_element_by_element():
    """One m entry moved by 3 x (|want| + rms) of its leaf fails the
    hard bound only if 3 > STATE_HARD; a share of moved entries over
    1 - STATE_TIGHT_SHARE fails the tight one."""
    g = torch.Generator().manual_seed(0)
    want = {"params": {"w": torch.randn(64, 64, generator=g).bfloat16()},
            "state": {"m": {"w": torch.randn(64, 64, generator=g)},
                      "v": {"w": torch.rand(64, 64, generator=g)},
                      "step": torch.tensor(1)}}
    same = mp.leaf_diffs(want, want, 1e-3)
    assert same["ok"] and same["leaves_bit_equal"] == same["leaves"] == 4
    m = want["state"]["m"]["w"]
    floor = float(m.abs()[0, 0] + m.square().mean().sqrt())
    moved = m.clone()
    moved[0, 0] += 3 * floor
    got = {**want, "state": {**want["state"], "m": {"w": moved}}}
    one = mp.leaf_diffs(got, want, 1e-3)
    assert one["m_worst_of_hard_bound"] == pytest.approx(
        3 / mp.STATE_HARD, rel=1e-6)
    assert one["ok"] == (3 <= mp.STATE_HARD)
    assert one["differing_leaves"] == ["state/m/w"]
    many = m.clone()
    many[:4] += 0.1 * m.square().mean().sqrt()       # 6.25% of the entries
    got = {**want, "state": {**want["state"], "m": {"w": many}}}
    assert not mp.leaf_diffs(got, want, 1e-3)["ok"]
