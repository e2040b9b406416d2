"""Shared arithmetic of the readers: tails over all samples, the window's
tokens, and the traced steps' work."""
from __future__ import annotations

from typing import List

import numpy as np

from portbench import flops


def percentile(values: List[float], q: float):
    """The q-th percentile (linear between order statistics) over every
    sample, or None where there is none."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) \
        if len(values) else None


def ttfts_s(served) -> List[float]:
    """First-token stamp minus due time of every request due in the window;
    one with no first token counts with the time it had waited when the
    run stopped."""
    return [(t.stamps[0] if t.stamps else served.end_t) - t.due_t
            for t in served.window_due]


def window_stamps(served) -> List[float]:
    return [s for t in served.tracks for s in t.stamps
            if served.open_t < s <= served.close_t]


def gaps_s(served) -> List[float]:
    """Every gap between consecutive tokens of a request whose later token
    was delivered in the window."""
    out = []
    for t in served.tracks:
        st = t.stamps
        out.extend(st[i] - st[i - 1] for i in range(1, len(st))
                   if served.open_t < st[i] <= served.close_t)
    return out


def window_tokens_per_s(served) -> float:
    return len(window_stamps(served)) / (served.close_t - served.open_t)


def prefill_flops(run) -> float:
    return sum(flops.prefill_flops(run.config, n)
               for s in run.traced_steps for n in s.prefills)


def decode_flops(run) -> float:
    return sum(flops.decode_flops(run.config, s.keys)
               for s in run.traced_steps if s.keys)


def share(part, whole):
    """part / whole in percent; None where either is missing or whole is 0."""
    if part is None or not whole:
        return None
    return 100.0 * part / whole
