"""WarmPoolController: the per-(function, platform) replica-lifecycle
control loop (repro_torch.autoscale).

The controller owns every managed platform's warm pools.  On attach it
takes over keep-alive from the platform's own faas-idler
(``managed_keepalive``) and installs a per-platform admission counter the
platforms increment on enqueue (``autoscale_counts`` — one dict add per
admitted invocation, zero cost when autoscaling is off).  Every ``tick_s``
sim-seconds it then

  1. drains the admission counters into the columnar counts buffer (one
     row per managed (function, platform) pair),
  2. runs the keep-alive policy's fused array tick -> per-row ``desired``
     warm-pool size and keep-alive ``ttl_s``,
  3. grows pools below target (``platform.prewarm``) and TTL-sweeps pools
     above it (``platform.enforce_keepalive`` / ``retire``), both O(1)
     running-total transitions on the platform.

Idle pools are read back through the platforms' O(1) idle counters,
cached per platform and refreshed only when that platform's idle
generation moved, so a steady-state tick is a handful of fused array ops
plus one dict check per platform — ``benchmarks/bench_autoscale.py`` pins
the tick throughput.  Everything advances on the deterministic SimClock:
two runs of one seeded scenario make byte-identical prewarm/retire
decisions.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.autoscale.policies import KeepAlivePolicy
from repro_torch.core.behavioral import FunctionPerformanceModel
from repro_torch.core.platform import TargetPlatform
from repro_torch.core.simulator import SimClock
from repro_torch.core.types import FunctionSpec


class _PlatformRows:
    """Controller-side view of one platform's managed rows."""

    __slots__ = ("platform", "row_of", "fns", "gen")

    def __init__(self, platform: TargetPlatform):
        self.platform = platform
        self.row_of: Dict[str, int] = {}
        self.fns: Dict[str, FunctionSpec] = {}
        self.gen = -1                      # force first idle refresh


class WarmPoolController:
    def __init__(self, platforms: Dict[str, TargetPlatform],
                 perf: FunctionPerformanceModel, clock: SimClock,
                 policy: KeepAlivePolicy, tick_s: float = 1.0,
                 exec_refresh_ticks: int = 64):
        self.platforms = platforms          # live dict (control plane's)
        self.perf = perf
        self.clock = clock
        self.policy = policy
        self.tick_s = float(tick_s)
        self.exec_refresh_ticks = int(exec_refresh_ticks)
        self.ticks = 0
        self.prewarmed = 0
        self.retired = 0
        # flight recorder (repro_torch.obs); set by the control plane's
        # attach_recorder / attach_autoscaler
        self.recorder = None
        self._plats: List[_PlatformRows] = []
        self._by_name: Dict[str, _PlatformRows] = {}
        self._rows = 0
        self._row_fn: List[FunctionSpec] = []
        self._row_platform: List[TargetPlatform] = []
        self._counts = np.zeros(0)
        self._idle = np.zeros(0)
        self._exec_s = np.zeros(0)
        self._need = np.zeros(0)
        self._next_sweep = np.zeros(0)
        self._sweep_mask = np.zeros(0, dtype=bool)
        self._touched: List[int] = []
        self._sweep_due = float("inf")
        self._started = False
        self._stopped = False

    # ----------------------------------------------------------- wiring ---
    def attach(self) -> "WarmPoolController":
        for p in list(self.platforms.values()):
            self.adopt(p)
        return self

    def adopt(self, platform: TargetPlatform) -> None:
        """Take over one platform's warm-pool lifecycle (elastic platforms
        may join mid-run)."""
        name = platform.prof.name
        if name in self._by_name:
            return
        platform.autoscale_counts = {}
        platform.managed_keepalive = True
        pv = _PlatformRows(platform)
        self._plats.append(pv)
        self._by_name[name] = pv
        self._sync_platform(pv)

    def _sync_platform(self, pv: _PlatformRows) -> None:
        for fn_name, spec in pv.platform.deployed.items():
            if fn_name not in pv.row_of:
                self._add_row(pv, fn_name, spec)

    def _add_row(self, pv: _PlatformRows, fn_name: str,
                 spec: FunctionSpec) -> int:
        row = self._rows
        pv.row_of[fn_name] = row
        pv.fns[fn_name] = spec
        pv.gen = -1                        # idle view must refresh
        self._row_fn.append(spec)
        self._row_platform.append(pv.platform)
        self._rows += 1
        for name in ("_counts", "_idle", "_exec_s", "_need",
                     "_next_sweep"):
            arr = getattr(self, name)
            grown = np.zeros(self._rows)
            grown[:row] = arr
            setattr(self, name, grown)
        self._sweep_mask = np.zeros(self._rows, dtype=bool)
        self.policy.resize(self._rows)
        # seed only the new row's Little's-law column (a full refresh per
        # added row would make attach quadratic in managed rows)
        self._exec_s[row] = self.perf.predict_exec(spec, pv.platform.prof)
        self.policy.set_exec(self._exec_s, self.tick_s)
        return row

    def _refresh_exec(self) -> None:
        """Re-pull predicted execution seconds (the Little's-law column)
        from the online perf model; called on row growth and every
        ``exec_refresh_ticks`` ticks."""
        perf, exec_s = self.perf, self._exec_s
        for r in range(self._rows):
            exec_s[r] = perf.predict_exec(self._row_fn[r],
                                          self._row_platform[r].prof)
        self.policy.set_exec(exec_s, self.tick_s)

    # ------------------------------------------------------------- tick ---
    def tick(self) -> None:
        """One control-loop pass; see the module docstring."""
        self.ticks += 1
        counts = self._counts
        touched = self._touched
        has_arrivals = False
        for pv in self._plats:
            c = pv.platform.autoscale_counts
            if c:
                row_of = pv.row_of
                for fn_name, n in c.items():
                    r = row_of.get(fn_name)
                    if r is None:          # deployed mid-run
                        spec = pv.platform.deployed.get(fn_name)
                        if spec is None:
                            continue
                        r = self._add_row(pv, fn_name, spec)
                        counts = self._counts
                    counts[r] = n
                    touched.append(r)
                c.clear()
                has_arrivals = True
        if self.ticks % self.exec_refresh_ticks == 0:
            self._refresh_exec()

        desired, ttl_s = self.policy.tick(counts, has_arrivals)

        if touched:
            for r in touched:
                counts[r] = 0.0
            touched.clear()

        # refresh the cached idle view only for platforms that moved
        # (an idle transition also re-arms the platform's sweep timers)
        idle = self._idle
        next_sweep = self._next_sweep
        moved = False
        for pv in self._plats:
            p = pv.platform
            g = p.idle_gen
            if g != pv.gen:
                pv.gen = g
                moved = True
                idle_warm = p.idle_warm
                for fn_name, r in pv.row_of.items():
                    idle[r] = idle_warm(fn_name)
                    next_sweep[r] = 0.0

        # quiet tick: decisions frozen (dormant policy), idle pools
        # untouched -> need is unchanged from its cached evaluation, so
        # the only possible action is a TTL expiry coming due
        now = self.clock.now()
        if not (has_arrivals or moved) or self._rows == 0:
            if now >= self._sweep_due:
                self._run_sweeps(now, desired, ttl_s)
            return
        need = self._need
        np.subtract(desired, idle, out=need)
        # grow pools below target ...
        if need.max() > 0.0:
            rec = self.recorder
            for r in np.flatnonzero(need > 0.0):
                n = int(need[r])
                self._row_platform[r].prewarm(self._row_fn[r].name, n)
                self.prewarmed += n
                if rec is not None:
                    rec.record_prewarm(self._row_platform[r].prof.name,
                                       self._row_fn[r].name, now, n)
        # ... and TTL-sweep pools above it, but only rows whose earliest
        # possible expiry has arrived (enforce_keepalive hands back the
        # next due time, so quiet pools are not re-scanned every tick)
        if need.min() < 0.0:
            self._run_sweeps(now, desired, ttl_s)
        else:
            self._sweep_due = float("inf")

    def _run_sweeps(self, now: float, desired: np.ndarray,
                    ttl_s: np.ndarray) -> None:
        """Sweep every surplus row whose earliest expiry has arrived and
        re-arm the cached next-due time."""
        next_sweep = self._next_sweep
        np.less(self._need, 0.0, out=self._sweep_mask)
        due = self._sweep_mask & (next_sweep <= now)
        rec = self.recorder
        for r in np.flatnonzero(due):
            n, nxt = self._row_platform[r].enforce_keepalive(
                self._row_fn[r].name, float(ttl_s[r]),
                keep=int(desired[r]))
            self.retired += n
            next_sweep[r] = nxt
            if n and rec is not None:
                rec.record_retire(self._row_platform[r].prof.name,
                                  self._row_fn[r].name, now, n)
        pending = next_sweep[self._sweep_mask]
        self._sweep_due = float(pending.min()) if pending.size \
            else float("inf")

    # -------------------------------------------------------- scheduling --
    def start(self) -> None:
        """Self-rescheduling tick on the sim clock (idempotent)."""
        if self._started:
            return
        self._started = True
        self._stopped = False

        def loop():
            if self._stopped:
                return
            self.tick()
            self.clock.after(self.tick_s, loop)

        self.clock.after(self.tick_s, loop)

    def stop(self) -> None:
        self._stopped = True
        self._started = False
