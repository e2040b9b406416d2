"""The readings a cell's limit is set from: for each seed, a run of the cell
(a short window at the cell's own load), the sound reading (the program's
served tokens against the f32 reference) and the control's reading (at
each position of the same prompts and tokens, the f32 reference's gap of
the token that the fp8 reference puts first). One process serves every
seed.

    python3 portbench/calibrate.py --workload qwen3-0.6b.chat \\
        --seconds 8 --seeds 11 12 13

One JSON line a seed. It is no part of a benchmark run.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import harness, reference  # noqa: E402


MARGINS = (0.0, 0.002, 0.005, 0.01, 0.02)


def readings(config: dict, tree: dict, picked, device) -> dict:
    """Sound and control readings at each routing margin of MARGINS: the
    program's served tokens against the f32 reference, and the tokens the
    fp8 reference puts first, at the same prompts and tokens."""
    seqs, n_prompts, served = harness.inputs(picked, device)
    ref = reference.Reference(config, tree)
    want = ref.logits(seqs, n_prompts)
    low = reference.Reference(config, tree, precision="fp8").logits(
        seqs, n_prompts)
    out = {}
    for tau in MARGINS:
        sound = reference.gap_numbers([
            reference.served_gaps(w, s, m, tau)
            for w, s, m in zip(want, served, ref.margins)])
        ctrl = reference.gap_numbers([
            reference.served_gaps(w, lo.argmax(-1), m, tau)
            for w, lo, m in zip(want, low, ref.margins)])
        out[str(tau)] = {"sound": sound, "control": ctrl}
        if ref.margins[0] is None:
            break
    return out


def with_control(files: dict, seed: int, seconds: float, device) -> dict:
    """One run of the cell whose comparison also reads the control."""
    out, _ = harness.run_cell(files, seed, seconds, False, device,
                              time.perf_counter(), on_compare=readings)
    return {"seed": seed, "readings": out.get("readings"),
            "correct": out["correct"], "metrics": {
                k: v["value"] for k, v in out["metrics"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rate", type=float, default=None,
                    help="offered load in place of the cell's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    files = harness.cell_files(args.workload, ROOT)
    if args.rate is not None:
        files["params"] = dict(files["params"], rate_per_s=args.rate)
    for seed in args.seeds:
        print(json.dumps(with_control(files, seed, args.seconds, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
