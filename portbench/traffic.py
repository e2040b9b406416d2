"""The one traffic generator: a mix file's parameters and the seed give the
requests of a run.

Every seed serves the same set of sizes and arrival gaps, in another order.
The sizes are the distribution's quantiles at (i + 0.5) / n, so a run's work
does not swing with the seed; the seed only orders them and draws the token
ids. The sizes' order is a blocked shuffle: the sorted sizes are cut into
BLOCK strata, and each run of BLOCK consecutive requests takes one size of
every stratum, so any stretch of the schedule holds about the same mix. The
inter-arrival gaps of a Poisson mix are the exponential distribution's
quantiles in an order drawn whole from the seed (no strata): any k
consecutive gaps are a draw without replacement from the exponential, so
the arrivals bunch and thin as a Poisson stream's do (the counts in 5-s
bins spread with the Poisson's variance, ``test_portbench_traffic.py``),
and only the total over all n gaps is the same for every seed.

A mix file (``mixes/<name>.json``) holds:

* ``arrivals``: ``"poisson"`` (open loop; the rate, in requests a second,
  is the cell's, from ``cells/<workload>.json``) or ``"backlog"`` (every
  request queued before the window; ``backlog`` requests);
* ``prompt_tokens`` / ``output_tokens``: ``{"dist": "lognormal", "median",
  "sigma", "min", "max"}`` or ``{"dist": "uniform", "min", "max"}``
  (integers, both ends included);
* ``slots`` and ``max_context``: the engine's batch and context;
* ``ramp_s``: seconds of traffic before the window opens.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np

BLOCK = 16
# seconds past the window's close that a run may keep serving, so that each
# request due in the window gets its first token
DRAIN_S = 30.0


@dataclass
class Due:
    """One request of the schedule: when it is due (seconds after the ramp
    starts), its prompt (int32 token ids) and how many tokens it asks for."""
    rid: int
    due_s: float
    prompt: np.ndarray
    max_new_tokens: int


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for each use of the seed; any whole
    number is a seed (negative and past 64 bits included)."""
    return np.random.default_rng([seed % 2 ** 64, stream])


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The n lengths at quantiles (i + 0.5) / n of ``spec``, ascending."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
        out = np.rint(x)
    elif spec["dist"] == "uniform":
        out = lo + np.floor(u * (hi - lo + 1))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(out, lo, hi).astype(np.int64)


def blocked_shuffle(sorted_values: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
    """``sorted_values`` (a whole number of BLOCKs) reordered so that every
    run of BLOCK consecutive entries holds one entry of each of BLOCK strata
    of the sorted order."""
    n = len(sorted_values)
    if n % BLOCK:
        raise ValueError(f"{n} values are not a whole number of blocks of "
                         f"{BLOCK}")
    m = n // BLOCK
    strata = sorted_values.reshape(BLOCK, m)
    picks = np.stack([rng.permutation(m) for _ in range(BLOCK)])
    blocks = strata[np.arange(BLOCK)[:, None], picks].T        # (m, BLOCK)
    for row in blocks:
        rng.shuffle(row)
    return blocks.reshape(-1)


def count(mix: dict, rate: float, seconds: float) -> int:
    """How many requests a run draws: a backlog's size, or enough Poisson
    arrivals to cover the ramp, the window and the drain after it; rounded
    up to whole blocks, so that the longest sizes are spread over the
    schedule like the others."""
    if mix["arrivals"] == "backlog":
        n = int(mix["backlog"])
    else:
        n = int(math.ceil(rate * (mix["ramp_s"] + seconds + DRAIN_S)))
    return BLOCK * max(1, math.ceil(n / BLOCK))


def schedule(mix: dict, seed: int, vocab: int, rate: float,
             seconds: float) -> List[Due]:
    """The requests of one run, in the order they are due."""
    n = count(mix, rate, seconds)
    order = rng_for(seed, 0)
    prompt_len = blocked_shuffle(quantiles(mix["prompt_tokens"], n), order)
    out_len = blocked_shuffle(quantiles(mix["output_tokens"], n), order)
    if mix["arrivals"] == "poisson":
        if not rate > 0:
            raise ValueError("a Poisson mix needs the cell's rate (> 0)")
        u = (np.arange(n) + 0.5) / n
        gaps = (-np.log1p(-u) / rate)[order.permutation(n)]
        due = np.cumsum(gaps)
    elif mix["arrivals"] == "backlog":
        due = np.zeros(n)
    else:
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    ids = rng_for(seed, 1)
    return [Due(i, float(due[i]),
                ids.integers(0, vocab, int(prompt_len[i]), dtype=np.int32),
                int(out_len[i])) for i in range(n)]
