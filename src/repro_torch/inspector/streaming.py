"""Chunked streaming replay of Azure-scale minute-count traces.

The discrete-event simulator materializes an ``Invocation`` per arrival
and walks every completion through the event queue — right for paper
figures at 10^4..10^6 invocations, hopeless at the public Azure trace's
scale (14 days, ~10^8 invocations).  The streaming replayer keeps the
whole replay columnar and bounded:

  * arrivals are generated one minute-chunk at a time straight into
    ``InvocationBatch`` columns (never a Python object per arrival);
  * each chunk is one re-snapshot + one fused ``Policy.fn_decisions``
    pass — the same filter-cascade + argmin the control plane's
    ``_submit_columns`` uses, on the backend that ``"auto"`` picks for the
    chunk's distinct functions — so replaying N chunks measures a loop
    over the fused admission step;
  * the columnar sink is the perf model itself: a chunk's admissions
    fold into the (function, platform) EWMA/P² arrays via
    ``fold_observations`` (the exact closed-form constant-input fold),
    plus bincount totals.  Peak memory is O(chunk rows + model cells),
    independent of trace length.

What this deliberately does NOT model: queueing and replica execution.
The replayer evolves admission decisions and perf-model state under the
full trace; per-invocation response curves stay the simulator's job at
simulator scale.  Chunk arrival columns are byte-identical to
``traces.counts_to_arrivals`` applied per chunk with the chunk's seed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.invocation_batch import InvocationBatch
from repro_torch.core.scheduler import as_snapshot
from repro_torch.core.types import FunctionSpec


@dataclass
class StreamStats:
    """Totals accumulated by ``stream_replay`` (arrays folded to dicts)."""

    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    chunks: int = 0
    peak_chunk_rows: int = 0
    per_platform: Dict[str, int] = field(default_factory=dict)
    per_function: Dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "submitted": self.submitted, "admitted": self.admitted,
            "rejected": self.rejected, "chunks": self.chunks,
            "peak_chunk_rows": self.peak_chunk_rows,
            "per_platform": dict(self.per_platform),
            "per_function": dict(self.per_function),
        }


def chunk_batch(spec_list: Sequence[FunctionSpec], sub: np.ndarray,
                m0: int, minute_s: float, seed: int) -> InvocationBatch:
    """One minute-chunk of a counts matrix as an ``InvocationBatch``.

    ``sub`` is the (F, W) count slice for minutes ``[m0, m0 + W)``.
    Arrivals land uniformly at random (seeded) inside their minute and
    the chunk is stable-sorted by time, exactly like
    ``counts_to_arrivals`` — a chunk is a replayable artifact."""
    w = sub.shape[1]
    flat = sub.T.ravel()                       # minute-major, fn order
    n = int(flat.sum())
    fn_of = np.tile(np.arange(sub.shape[0], dtype=np.int32), w)
    min_of = np.repeat(np.arange(m0, m0 + w), sub.shape[0])
    fn_col = np.repeat(fn_of, flat)
    rng = np.random.default_rng(seed)
    t_col = (np.repeat(min_of, flat) + rng.random(n)) * minute_s
    order = np.argsort(t_col, kind="stable")
    return InvocationBatch(list(spec_list), fn_col[order], t_col[order])


def stream_replay(cp, specs: Mapping[str, FunctionSpec],
                  counts: Mapping[str, np.ndarray], *,
                  minute_s: float = 60.0, chunk_minutes: int = 60,
                  seed: int = 0,
                  on_chunk: Optional[Callable[[int, int], None]] = None
                  ) -> StreamStats:
    """Stream an Azure-style minute-count trace through the control
    plane's fused admission step, chunk by chunk.

    ``counts`` maps function name -> per-minute invocation counts (the
    ``traces`` module's Azure format); ``specs`` resolves each name to
    its deployed ``FunctionSpec``.  Per chunk: build the arrival columns,
    re-snapshot the platforms, run one ``fn_decisions`` pass, then fold
    the chunk into the columnar sink — arrival-rate windows
    (``events.record_many`` per (fn, rate window)), co-invocation edges
    (``record_batch_columns``), per-cell EWMA/P² state
    (``fold_observations`` with the platform's predicted exec/response),
    and KB decision counters.  ``on_chunk(i, rows)`` fires after each
    chunk (RSS probes hook here).  Stateful policies that cannot make
    per-function decisions route via one representative materialized row
    per present function."""
    names = list(counts)
    tel = cp.metrics.telemetry    # live rollups fold per chunk when set
    spec_list = [specs[name] for name in names]
    mat = np.stack([np.asarray(counts[name], dtype=np.int64)
                    for name in names])
    n_fns, minutes = mat.shape
    admitted_fp: Dict[tuple, int] = {}
    stats = StreamStats()
    rej_f = np.zeros(n_fns, np.int64)
    adm_f = np.zeros(n_fns, np.int64)

    for ci, m0 in enumerate(range(0, minutes, chunk_minutes)):
        sub = mat[:, m0:m0 + chunk_minutes]
        fn_counts = sub.sum(axis=1)
        n = int(fn_counts.sum())
        if n == 0:
            continue
        batch = chunk_batch(spec_list, sub, m0, minute_s,
                            seed * 1_000_003 + ci)
        stats.chunks += 1
        stats.submitted += n
        stats.peak_chunk_rows = max(stats.peak_chunk_rows, n)

        # arrival bookkeeping: fold the chunk's real timestamps into the
        # rate model's own windows (lumping a minute's count at its
        # boundary would leave the intermediate windows empty and drag
        # the Holt level to zero), plus one columnar pass over the chunk
        # for co-invocation edges
        win_s = cp.events.window_s
        win_col = (batch.arrival_t // win_s).astype(np.int64)
        for j in range(n_fns):
            if not fn_counts[j]:
                continue
            wins, wc = np.unique(win_col[batch.fn_idx == j],
                                 return_counts=True)
            for w, c in zip(wins.tolist(), wc.tolist()):
                cp.events.record_many(names[j], w * win_s, int(c))
        cp.interactions.record_batch_columns(batch.fn_idx, names,
                                             (m0 + sub.shape[1]) * minute_s)

        # one fused decision per distinct function in the chunk
        present = [j for j in range(n_fns) if fn_counts[j]]
        pres_specs = [spec_list[j] for j in present]
        snap = as_snapshot(cp.alive_platforms())
        res = cp.policy.fn_decisions(pres_specs, snap)
        if res is None:                 # stateful policy: one row per fn
            reps = [batch.materialize(
                int(np.nonzero(batch.fn_idx == j)[0][0])) for j in present]
            tmap = cp.policy.choose_batch(reps, snap)
        else:
            idx, ok = res
            tmap = [snap.platforms[int(idx[g])] if ok[g] else None
                    for g in range(len(present))]

        chunk_admitted = 0
        for g, j in enumerate(present):
            k = int(fn_counts[j])
            target = tmap[g]
            if target is None:
                batch.state[batch.fn_idx == j] = InvocationBatch.REJECTED
                rej_f[j] += k
                continue
            batch.state[batch.fn_idx == j] = InvocationBatch.ADMITTED
            fn, prof = spec_list[j], target.prof
            exec_s = cp.perf.predict_exec(fn, prof)
            access_s = sum(cp.placement.access_time(key, prof.name)
                           for key in fn.data_objects)
            cp.perf.fold_observations(fn.name, prof.name, exec_s,
                                      exec_s + access_s, k)
            if tel is not None:
                tel.observe_many(prof.name, fn.name, "response_time",
                                 batch.arrival_t[batch.fn_idx == j],
                                 np.full(k, exec_s + access_s))
            adm_f[j] += k
            chunk_admitted += k
            cell = (j, prof.name)
            admitted_fp[cell] = admitted_fp.get(cell, 0) + k
        cp.kb.count_decisions(chunk_admitted)
        stats.admitted += chunk_admitted
        if tel is not None:
            # fold the chunk's rollups now: pending buffers stay O(chunk)
            # and a 14-day replay keeps O(tiers x capacity) rollup state
            tel.flush()
        if on_chunk is not None:
            on_chunk(ci, n)

    stats.rejected = int(rej_f.sum())
    stats.per_function = {names[j]: int(adm_f[j]) for j in range(n_fns)
                          if adm_f[j]}
    for (j, pname), k in admitted_fp.items():
        stats.per_platform[pname] = stats.per_platform.get(pname, 0) + k
    return stats
