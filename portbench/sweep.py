"""The knee of a rate cell: the cell's traffic at each offered rate, one run
a rate in one process, and how the backlog (requests due and not yet
admitted) moved over the window. The knee is the highest rate whose backlog
does not grow; the cell runs at about four fifths of it.

    python3 portbench/sweep.py --workload qwen3-0.6b.chat --seconds 20 \\
        --rates 2 4 6 8

One JSON line a rate. It is no part of a benchmark run.
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

from portbench import harness, loop  # noqa: E402


def backlog(served: loop.Served, t: float) -> int:
    """Requests due by ``t`` that had no first token at ``t``."""
    return sum(1 for tr in served.tracks if tr.due_t <= t
               and not (tr.stamps and tr.stamps[0] <= t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    files = harness.cell_files(args.workload, ROOT)
    for rate in args.rates:
        f = dict(files, params=dict(files["params"], rate_per_s=rate))
        out, s = harness.run_cell(f, args.seed, args.seconds, False, "cuda",
                                  time.perf_counter())
        print(json.dumps({
            "rate": rate, "backlog_open": backlog(s, s.open_t),
            "backlog_close": backlog(s, s.close_t),
            "backlog_max": max((backlog(s, st.t1) for st in s.steps
                                if s.open_t <= st.t1 <= s.close_t),
                               default=0),
            "drained": s.drained, "correct": out["correct"],
            "memory_peak_bytes": out["device"]["memory_peak_bytes"],
            "metrics": {k: v["value"] for k, v in
                        out["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
