"""k6-style load generator (paper §4.3), in two workload models:

Closed loop — ``run_load``: N virtual users (VUs) iterate request ->
wait-for-completion -> sleep, exactly the way the paper's k6 scripts drove
the five platforms (VUs 10-50, duration 600 s, optional sleep).

Open loop — arrival-driven: ``poisson_arrivals`` / ``trace_arrivals``
produce a NumPy array of arrival timestamps (seeded Poisson process, or a
replayable trace), and ``run_arrivals`` admits them through a batch-submit
callable (``FDNControlPlane.submit_batch`` / ``Gateway.request_batch``),
grouping arrivals into sub-window bursts.  ``run_arrival_mix`` is the
multi-function variant: a merged arrival stream tagged with a function
index per arrival (see the JAX package's
``inspector.traces.WorkloadMix``).  Results stream into a
``ColumnarResultSink`` — flat NumPy columns, no Python object retained per
latency sample — so a run can sustain ~10^6 invocations.

Everything is deterministic on the SimClock; all randomness is seeded.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.invocation_batch import InvocationBatch
from repro_torch.core.simulator import SimClock
from repro_torch.core.types import FunctionSpec, Invocation


@dataclass
class LoadResult:
    invocations: List[Invocation]

    @property
    def completed(self) -> List[Invocation]:
        return [i for i in self.invocations if i.status == "done"]

    def p90_response(self) -> float:
        from repro_torch.core.monitoring import percentile_unsorted
        vals = np.array([i.response_time for i in self.completed
                         if i.response_time is not None])
        return percentile_unsorted(vals, 0.90)

    def requests_per_s(self, duration: float) -> float:
        return len(self.completed) / max(duration, 1e-9)


def spawn_vus(clock: SimClock, submit: Callable[[Invocation], None],
              fn: FunctionSpec, vus: int, t_end: float,
              sleep_s: float = 0.0, seed: int = 42, jitter: float = 0.05,
              out: Optional[List[Invocation]] = None,
              qos: int = 1, tenant: int = 0) -> List[Invocation]:
    """Schedule `vus` virtual-user loops on the clock WITHOUT running it.

    Each VU iterates request -> wait-for-completion -> think-sleep until
    ``t_end``.  The caller advances the clock (``run_load`` drives a single
    workload; the FDNInspector scenario runner spawns several VU pools plus
    open-loop arrival streams and runs them all on one clock)."""
    rng = random.Random(seed)
    invs: List[Invocation] = out if out is not None else []

    def vu_loop(vu_id: int):
        if clock.now() >= t_end:
            return
        inv = Invocation(fn, clock.now(), vu=vu_id, qos=qos,
                         tenant=tenant)
        invs.append(inv)
        done_flag = {"fired": False}

        def next_iter(_inv=inv):
            if done_flag["fired"]:
                return
            done_flag["fired"] = True
            think = sleep_s + rng.random() * jitter
            clock.after(think, lambda: vu_loop(vu_id))

        inv._on_done = next_iter          # platform completion hook
        submit(inv)
        # safety: if the invocation was rejected outright, keep iterating —
        # but only if the completion hook has not already rescheduled this
        # VU.  A platform that both fails the submit AND later fires
        # _on_done (redelivery, hedging) must not fork the virtual user.
        if inv.status == "failed" and not done_flag["fired"]:
            done_flag["fired"] = True
            clock.after(max(sleep_s, 0.1), lambda: vu_loop(vu_id))

    for v in range(vus):
        clock.after(rng.random() * 0.1, lambda v=v: vu_loop(v))
    return invs


def run_load(clock: SimClock, submit: Callable[[Invocation], None],
             fn: FunctionSpec, vus: int, duration_s: float,
             sleep_s: float = 0.0, seed: int = 42,
             jitter: float = 0.05, drain_s: float = 120.0) -> LoadResult:
    """Spawn `vus` virtual users for `duration_s` sim-seconds.

    After the VU window closes, the clock drains for up to `drain_s` so
    in-flight invocations complete (k6's gracefulStop)."""
    t_end = clock.now() + duration_s
    out = spawn_vus(clock, submit, fn, vus, t_end, sleep_s=sleep_s,
                    seed=seed, jitter=jitter)
    clock.run_until(t_end)
    clock.run_until(t_end + drain_s)          # gracefulStop: drain in-flight
    return LoadResult(out)


def run_open_loop(clock: SimClock, submit: Callable[[Invocation], bool],
                  fn: FunctionSpec, rps: float, duration_s: float,
                  seed: int = 42) -> LoadResult:
    """Open-loop (arrival-rate) load: k6's constant-arrival-rate executor.
    Used for the Table-4 energy experiment (fixed 40 req/s per platform).

    Thin wrapper over ``uniform_arrivals`` + ``run_arrivals`` (the
    hand-rolled arrival loop predated the batch path); ``batch_window_s=0``
    keeps the historical per-invocation submit semantics.  ``seed`` is
    retained for signature compatibility — evenly spaced arrivals need no
    randomness."""
    del seed
    out: List[Invocation] = []

    def submit_each(invs: List[Invocation]) -> int:
        out.extend(invs)
        return sum(1 for inv in invs if submit(inv))

    arrivals = uniform_arrivals(rps, duration_s, t0=clock.now())
    run_arrivals(clock, submit_each, fn, arrivals, batch_window_s=0.0,
                 drain_s=60.0)
    return LoadResult(out)


# ---------------------------------------------------------------------------
# Open-loop arrival processes (workload-model diversity: the paper's k6
# constant-arrival executor, a Poisson process, and trace replay)
# ---------------------------------------------------------------------------

def poisson_arrivals(rps: float, duration_s: float, seed: int = 42,
                     t0: float = 0.0) -> np.ndarray:
    """Seeded Poisson arrival process: exponential inter-arrival gaps at
    mean rate ``rps`` for ``duration_s`` seconds.  Same seed -> identical
    arrival array (replayable)."""
    if rps <= 0 or duration_s <= 0:
        return np.empty(0)
    rng = np.random.default_rng(seed)
    # draw with headroom, extend until the window is covered
    n = max(int(rps * duration_s * 1.2) + 16, 16)
    gaps = rng.exponential(1.0 / rps, size=n)
    t = np.cumsum(gaps)
    while t[-1] < duration_s:
        more = rng.exponential(1.0 / rps, size=n)
        t = np.concatenate([t, t[-1] + np.cumsum(more)])
    return t0 + t[t < duration_s]


def uniform_arrivals(rps: float, duration_s: float,
                     t0: float = 0.0) -> np.ndarray:
    """k6 constant-arrival-rate executor: evenly spaced arrivals."""
    n = int(rps * duration_s)
    return t0 + np.arange(n) / rps


def trace_arrivals(times: Sequence[float], t0: float = 0.0,
                   time_scale: float = 1.0) -> np.ndarray:
    """Replay a recorded arrival trace (e.g. production timestamps),
    shifted to start at ``t0`` and optionally time-dilated."""
    t = np.sort(np.asarray(list(times), dtype=float))
    if t.size == 0:
        return t
    return t0 + (t - t[0]) * time_scale


class ColumnarResultSink:
    """Flat-column result collector for open-loop runs.

    Completions append scalars into growable NumPy columns (arrival time,
    end time, platform id, function id, exec time, cold-start flag);
    nothing per-sample survives in Python object form, so a 10^6-invocation
    run costs ~50 MB instead of a list of a million Invocation objects.
    """

    def __init__(self, capacity: int = 1024):
        self._n = 0
        self._arrival = np.empty(capacity)
        self._end = np.empty(capacity)
        self._exec = np.empty(capacity)
        self._platform = np.empty(capacity, np.int32)
        self._fn = np.empty(capacity, np.int32)
        self._cold = np.empty(capacity, bool)
        self._inv = np.empty(capacity, np.int64)
        self._qos = np.empty(capacity, np.int8)
        self._tenant = np.empty(capacity, np.int32)
        self._decision = np.empty(capacity, np.int64)
        self._platform_ids: Dict[str, int] = {}
        self._fn_ids: Dict[str, int] = {}
        self._fn_specs: Dict[str, FunctionSpec] = {}
        self.submitted = 0
        self.rejected = 0

    # -------------------------------------------------------- ingest ---
    def _grow(self, need: int):
        cap = max(self._arrival.size * 2, need)
        for name in ("_arrival", "_end", "_exec", "_platform", "_fn",
                     "_cold", "_inv", "_qos", "_tenant", "_decision"):
            a = getattr(self, name)
            b = np.empty(cap, a.dtype)
            b[:self._n] = a[:self._n]
            setattr(self, name, b)

    def record_completion(self, inv: Invocation):
        if self._n == self._arrival.size:
            self._grow(self._n + 1)
        i = self._n
        self._arrival[i] = inv.arrival_t
        self._end[i] = inv.end_t if inv.end_t is not None else np.nan
        self._exec[i] = inv.exec_time
        pid = self._platform_ids.setdefault(inv.platform or "?",
                                            len(self._platform_ids))
        self._platform[i] = pid
        fname = inv.fn.name
        fid = self._fn_ids.get(fname)
        if fid is None:
            fid = len(self._fn_ids)
            self._fn_ids[fname] = fid
            self._fn_specs[fname] = inv.fn
        self._fn[i] = fid
        self._cold[i] = inv.cold_start
        self._inv[i] = inv.id
        self._qos[i] = inv.qos
        self._tenant[i] = inv.tenant
        self._decision[i] = inv.decision
        self._n = i + 1

    @classmethod
    def from_columns(cls, arrival: np.ndarray, end: np.ndarray,
                     platforms: Sequence[str], platform_idx: np.ndarray,
                     fns: Sequence[FunctionSpec], fn_idx: np.ndarray,
                     cold: Optional[np.ndarray] = None,
                     exec_s: Optional[np.ndarray] = None
                     ) -> "ColumnarResultSink":
        """Build a sink directly from completion columns (synthetic-ingest
        benchmarks and tests; the live path is ``record_completion``)."""
        n = int(np.asarray(arrival).size)
        sink = cls(capacity=max(n, 1))
        sink._arrival[:n] = arrival
        sink._end[:n] = end
        sink._exec[:n] = exec_s if exec_s is not None \
            else np.asarray(end) - np.asarray(arrival)
        sink._platform[:n] = platform_idx
        sink._fn[:n] = fn_idx
        sink._cold[:n] = cold if cold is not None else False
        sink._inv[:n] = np.arange(n, dtype=np.int64)   # synthetic ids
        sink._qos[:n] = 1                              # standard class
        sink._tenant[:n] = 0
        sink._decision[:n] = -1                        # not journaled
        sink._platform_ids = {name: i for i, name in enumerate(platforms)}
        sink._fn_ids = {f.name: i for i, f in enumerate(fns)}
        sink._fn_specs = {f.name: f for f in fns}
        sink._n = n
        sink.submitted = n
        return sink

    def install(self, control_plane) -> "ColumnarResultSink":
        """Subscribe to every platform's completion stream."""
        for p in control_plane.platforms.values():
            if self.record_completion not in p.on_complete:
                p.on_complete.append(self.record_completion)
        return self

    # --------------------------------------------------------- stats ---
    @property
    def completed(self) -> int:
        return self._n

    def completion_columns(self) -> Dict:
        """The collected columns (views, not copies) plus the id maps —
        the contract consumed by ``MetricsRegistry.record_completions``."""
        n = self._n
        return {"arrival": self._arrival[:n], "end": self._end[:n],
                "exec": self._exec[:n], "platform": self._platform[:n],
                "fn": self._fn[:n], "cold": self._cold[:n],
                "inv_id": self._inv[:n], "qos": self._qos[:n],
                "tenant": self._tenant[:n],
                "decision": self._decision[:n],
                "platform_ids": dict(self._platform_ids),
                "fn_ids": dict(self._fn_ids),
                "fn_specs": dict(self._fn_specs)}

    def response_times(self) -> np.ndarray:
        return self._end[:self._n] - self._arrival[:self._n]

    def p90_response(self) -> float:
        from repro_torch.core.monitoring import percentile_unsorted
        rt = self.response_times()
        return percentile_unsorted(rt[~np.isnan(rt)], 0.90)

    def mean_response(self) -> float:
        rt = self.response_times()
        return float(np.nanmean(rt)) if rt.size else float("nan")

    def requests_per_s(self, duration: float) -> float:
        return self._n / max(duration, 1e-9)

    def cold_start_count(self) -> int:
        return int(self._cold[:self._n].sum())

    def platform_counts(self) -> Dict[str, int]:
        counts = np.bincount(self._platform[:self._n],
                             minlength=len(self._platform_ids))
        return {name: int(counts[pid])
                for name, pid in self._platform_ids.items()}

    def fn_counts(self) -> Dict[str, int]:
        counts = np.bincount(self._fn[:self._n],
                             minlength=len(self._fn_ids))
        return {name: int(counts[fid])
                for name, fid in self._fn_ids.items()}

    def to_metrics(self, registry, platform: str = "_loadgen",
                   fn: str = "*") -> None:
        """Push the collected latency column into a MetricsRegistry in one
        columnar ingest."""
        rt = self.response_times()
        ok = ~np.isnan(rt)
        registry.add_many(platform, fn, "response_time",
                          self._end[:self._n][ok], rt[ok])


def _burst_bounds(arrivals: np.ndarray,
                  batch_window_s: float) -> List[Tuple[int, int]]:
    """Index ranges of arrivals grouped into ``batch_window_s`` sub-window
    bursts (``<= 0``: every arrival is its own batch)."""
    if batch_window_s > 0:
        edges = np.arange(float(arrivals[0]),
                          float(arrivals[-1]) + batch_window_s,
                          batch_window_s)
        starts = np.searchsorted(arrivals, edges, side="left")
        return [(int(a), int(b)) for a, b in
                zip(starts, list(starts[1:]) + [arrivals.size]) if b > a]
    return [(i, i + 1) for i in range(arrivals.size)]


def schedule_arrival_mix(clock: SimClock,
                         submit_batch: Callable[[List[Invocation]], int],
                         specs: Sequence[FunctionSpec], times: np.ndarray,
                         fn_idx: np.ndarray, batch_window_s: float = 0.05,
                         sink: Optional[ColumnarResultSink] = None,
                         columnar: bool = False,
                         qos: Optional[np.ndarray] = None,
                         tenant: Optional[np.ndarray] = None
                         ) -> ColumnarResultSink:
    """Enqueue a multi-function arrival stream WITHOUT running the clock.

    ``times`` is the merged, sorted admission stream; ``fn_idx[i]`` indexes
    ``specs`` for arrival i (a single-function stream is the all-zeros
    case).  Optional ``qos`` / ``tenant`` columns (aligned with ``times``)
    tag each arrival with its QoS class id and tenant; omitted they keep
    the defaults (standard class, tenant 0).  Arrivals inside one
    ``batch_window_s`` sub-window are admitted together at the window's
    close; each invocation keeps its true arrival timestamp, so measured
    response times include the admission delay.

    ``columnar=True`` builds ONE ``InvocationBatch`` over the whole stream
    and fires zero-copy chunk views per sub-window — no per-arrival
    ``Invocation`` object is created at admission time (the platform
    materializes rows lazily as replicas start them).  Decisions and
    timings are identical to the object path.
    """
    sink = sink or ColumnarResultSink()
    times = np.asarray(times, dtype=float)
    fn_idx = np.asarray(fn_idx, dtype=np.int64)
    if times.size == 0:
        return sink
    bounds = _burst_bounds(times, batch_window_s)

    if columnar:
        stream = InvocationBatch(list(specs), fn_idx, times,
                                 qos=qos, tenant=tenant)

        def fire(lo: int, hi: int):
            chunk = stream.view(lo, hi)
            sink.submitted += chunk.n
            accepted = submit_batch(chunk)
            sink.rejected += chunk.n - accepted
    else:
        def fire(lo: int, hi: int):
            invs = [Invocation(specs[fn_idx[i]], float(times[i]),
                               qos=1 if qos is None else int(qos[i]),
                               tenant=0 if tenant is None
                               else int(tenant[i]))
                    for i in range(lo, hi)]
            sink.submitted += len(invs)
            accepted = submit_batch(invs)
            sink.rejected += len(invs) - accepted

    clock.schedule_many([float(times[hi - 1]) for lo, hi in bounds],
                        [lambda lo=lo, hi=hi: fire(lo, hi)
                         for lo, hi in bounds])
    return sink


def run_arrival_mix(clock: SimClock,
                    submit_batch: Callable[[List[Invocation]], int],
                    specs: Sequence[FunctionSpec], times: np.ndarray,
                    fn_idx: np.ndarray, batch_window_s: float = 0.05,
                    sink: Optional[ColumnarResultSink] = None,
                    drain_s: float = 120.0,
                    columnar: bool = False) -> ColumnarResultSink:
    """Open-loop replay of a multi-function arrival mix, then drain."""
    times = np.asarray(times, dtype=float)
    sink = schedule_arrival_mix(clock, submit_batch, specs, times, fn_idx,
                                batch_window_s, sink, columnar=columnar)
    if times.size:
        t_end = float(times[-1])
        clock.run_until(t_end)
        clock.run_until(t_end + drain_s)      # gracefulStop: drain in-flight
    return sink


def run_arrivals(clock: SimClock, submit_batch: Callable[[List[Invocation]],
                                                         int],
                 fn: FunctionSpec, arrivals: np.ndarray,
                 batch_window_s: float = 0.05, sink:
                 Optional[ColumnarResultSink] = None,
                 drain_s: float = 120.0) -> ColumnarResultSink:
    """Open-loop replay: admit ``arrivals`` through a batch-submit callable.

    Single-function case of ``run_arrival_mix`` (one spec, all-zero
    function indices).  With ``batch_window_s <= 0`` every arrival is its
    own batch (the per-invocation baseline).
    """
    arrivals = np.asarray(arrivals, dtype=float)
    return run_arrival_mix(clock, submit_batch, [fn], arrivals,
                           np.zeros(arrivals.size, np.int64),
                           batch_window_s, sink, drain_s)


def attach_completion_hooks(control_plane) -> None:
    """Wire Invocation._on_done callbacks through the control plane.

    Idempotent: the hook closure is cached on the control plane, so
    repeated calls (the scenario runner and a ChainExecutor both want the
    hooks) never double-fire a callback."""
    fire = getattr(control_plane, "_completion_hook", None)
    if fire is None:
        def fire(inv):
            cb = getattr(inv, "_on_done", None)
            if cb is not None:
                cb()
        control_plane._completion_hook = fire
    for p in control_plane.platforms.values():
        if fire not in p.on_complete:
            p.on_complete.append(fire)
