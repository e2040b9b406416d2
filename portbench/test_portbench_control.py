"""The control: the reference computed in fp8 (the precision below the
configurations' bf16) in the program's place must read past a cell's
limit. On the CPU at small sizes, the control's reading stands at least
three times over every sound reading; on the card, at each cell's own size
(``-m cuda``), it stands over the cell's limit and the sound run under it."""
import pytest
import torch

from portbench import calibrate, harness, small

CELLS = ("qwen3-0.6b.chat", "mixtral-8x7b-16l.chat", "qwen3-0.6b.offline")


def limits_of(cell):
    return harness.load(harness.HERE / "cells" / f"{cell}.json")["limits"]


def reading(r, limits):
    """The cell's compared numbers, sound and control, at its margin."""
    got = r["readings"].get(str(limits.get("route_margin", 0.0))) \
        or r["readings"]["0.0"]
    keys = [k for k in ("max_logit_gap", "mean_logit_gap") if k in limits]
    return ({k: got["sound"][k] for k in keys},
            {k: got["control"][k] for k in keys})


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_past_sound_runs_small(cell):
    torch.set_num_threads(2)
    limits = limits_of(cell)
    sound, control = [], []
    for seed in (21, 22, 23):
        r = calibrate.with_control(small.files(cell), seed, 1.0, "cpu")
        s, c = reading(r, limits)
        sound.append(s)
        control.append(c)
    # some compared number stands three times over every sound reading
    assert any(min(c[k] for c in control) >= 3 * max(
        max(s[k] for s in sound), 1e-4) for k in sound[0]), (sound, control)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    files = harness.cell_files(cell)
    limits = limits_of(cell)
    seconds = files["bench"]["run_seconds"]
    for seed in (31, 32, 33):
        r = calibrate.with_control(files, seed, seconds, "cuda")
        s, c = reading(r, limits)
        assert all(s[k] <= limits[k] for k in s), (seed, s)
        assert any(c[k] > limits[k] for k in c), (seed, c)
