"""Fault tolerance (paper §3.1.3 "Fault Tolerance"): failure detection,
re-delivery to another platform, hedged requests for stragglers, and
platform ejection / elastic re-admission.

  * FailureDetector — heartbeat-based with a phi-accrual-style suspicion
    score; platforms that miss heartbeats are ejected from scheduling.
  * Redeliverer    — failed/lost invocations are retried on the next-best
    platform (at-least-once delivery with bounded attempts).
  * HedgePolicy    — straggler mitigation: if an invocation has not
    completed within k x predicted P90, a speculative duplicate is sent to
    the second-best platform; first completion wins.
"""
from __future__ import annotations

import math
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional

from repro_torch.core.behavioral import FunctionPerformanceModel
from repro_torch.core.platform import TargetPlatform
from repro_torch.core.simulator import SimClock
from repro_torch.core.types import Invocation


class FailureDetector:
    """Phi-accrual-lite: suspicion grows with missed heartbeat intervals."""

    def __init__(self, clock: SimClock, interval_s: float = 5.0,
                 phi_threshold: float = 3.0):
        self.clock = clock
        self.interval = interval_s
        self.phi_threshold = phi_threshold
        self.last_beat: Dict[str, float] = {}
        self.ejected: Dict[str, bool] = defaultdict(bool)
        self.on_eject: List[Callable[[str], None]] = []
        self.on_recover: List[Callable[[str], None]] = []

    def heartbeat(self, platform: str):
        self.last_beat[platform] = self.clock.now()
        if self.ejected[platform]:
            self.ejected[platform] = False
            for cb in self.on_recover:
                cb(platform)

    def phi(self, platform: str) -> float:
        last = self.last_beat.get(platform)
        if last is None:
            return 0.0
        return (self.clock.now() - last) / self.interval

    def check(self, platform: str) -> bool:
        """True if the platform is considered alive."""
        if self.phi(platform) > self.phi_threshold:
            if not self.ejected[platform]:
                self.ejected[platform] = True
                for cb in self.on_eject:
                    cb(platform)
            return False
        return True


class Redeliverer:
    """At-least-once delivery with bounded attempts across platforms."""

    def __init__(self, max_attempts: int = 3):
        self.max_attempts = max_attempts
        self.redelivered = 0
        self.exhausted: List[Invocation] = []

    def handle_failure(self, inv: Invocation,
                       resubmit: Callable[[Invocation], None]):
        inv.attempts += 1
        if inv.attempts >= self.max_attempts:
            self.exhausted.append(inv)
            return
        inv.status = "pending"
        inv.platform = None
        inv.end_t = None
        self.redelivered += 1
        resubmit(inv)


class HedgePolicy:
    """Speculative duplicates after k x predicted P90 (straggler cut).

    Two watch granularities:
      * ``watch``       — one timer per invocation (the scalar path);
      * ``watch_group`` — ONE timer per (fn, platform) admission group: a
        burst of 10^4 admissions arms a handful of timers instead of 10^4,
        and the still-pending stragglers are duplicated and re-admitted as
        a single batch.  Equivalent to per-invocation watchers (same
        budget, same fire instant — every member of an admission group
        shares arrival time, function and platform).

    Group timers are *cancellable*: every armed group registers its
    members in a timer index, completions tick the group's pending count
    down, and when the last member finishes before the hedge budget the
    timer is dropped from the clock (the closure and its captured batch
    are freed immediately) instead of firing as a no-op.  Under sustained
    bursts that keeps the live-timer count proportional to the number of
    *straggling* groups, not the number of admitted groups.

    ``on_duplicate`` callbacks fire for every speculative duplicate
    created — the chain executor uses this to let a winning duplicate
    complete its stage.
    """

    def __init__(self, clock: SimClock, perf: FunctionPerformanceModel,
                 k: float = 2.0, enabled: bool = True):
        self.clock = clock
        self.perf = perf
        self.k = k
        self.enabled = enabled
        self.hedges_sent = 0
        self.hedges_won = 0
        self.group_timers_armed = 0
        self.group_timers_cancelled = 0
        self._live_groups = 0
        self._done: Dict[int, bool] = {}
        # cancellable group-timer index: inv.id -> its group's shared
        # record [pending_count, member_ids, TimerHandle]
        self._groups: Dict[int, list] = {}
        self.on_duplicate: List[Callable[[Invocation, Invocation],
                                         None]] = []

    def live_group_timers(self) -> int:
        """Armed group timers that have neither fired nor been cancelled
        (== groups with at least one still-pending member)."""
        return self._live_groups

    def _budget(self, fn, platform: TargetPlatform) -> Optional[float]:
        """Hedge delay, or None while the model lacks real latency
        observations — otherwise analytic estimates under cold starts
        cause hedge storms."""
        obs = self.perf.resp_p90.get((fn.name, platform.prof.name))
        if obs is None or obs.count < 10:
            return None
        return self.k * max(
            self.perf.predict_p90_response(fn, platform.prof), 1e-3)

    def _make_dup(self, inv: Invocation) -> Invocation:
        dup = Invocation(inv.fn, self.clock.now(), vu=inv.vu,
                         args=inv.args)
        dup.hedged_from = inv.id
        self.hedges_sent += 1
        for cb in self.on_duplicate:
            cb(inv, dup)
        return dup

    def watch(self, inv: Invocation, platform: TargetPlatform,
              alternates: List[TargetPlatform],
              submit: Callable[[Invocation, TargetPlatform], None]):
        if not self.enabled or not alternates:
            return
        budget = self._budget(inv.fn, platform)
        if budget is None:
            return
        self._done[inv.id] = False

        def maybe_hedge():
            if self._done.get(inv.id) or inv.status == "done":
                self._done.pop(inv.id, None)
                return
            submit(self._make_dup(inv), alternates[0])

        self.clock.after(budget, maybe_hedge)

    def watch_group(self, invs: List[Invocation],
                    platform: TargetPlatform,
                    alternates: List[TargetPlatform],
                    submit_many: Callable[[List[Invocation],
                                           TargetPlatform], None]):
        """One vectorized hedge timer for a whole (fn, platform) admission
        group; stragglers are duplicated in admission order and batch-
        submitted to the best alternate.  The timer is indexed by member:
        when every member completes before the budget it is cancelled and
        dropped from the clock instead of firing as a no-op."""
        if not self.enabled or not alternates or not invs:
            return
        budget = self._budget(invs[0].fn, platform)
        if budget is None:
            return
        member_ids = [inv.id for inv in invs]
        group = [len(invs), member_ids, None]
        groups = self._groups

        def maybe_hedge_group():
            self._live_groups -= 1
            dups = []
            for inv in invs:
                groups.pop(inv.id, None)
                if inv.status == "done":
                    continue
                dups.append(self._make_dup(inv))
            if dups:
                submit_many(dups, alternates[0])

        group[2] = self.clock.after_cancellable(budget, maybe_hedge_group)
        for iid in member_ids:
            groups[iid] = group
        self.group_timers_armed += 1
        self._live_groups += 1

    def completed(self, inv: Invocation):
        if inv.hedged_from is not None:
            self.hedges_won += 1
        # only flip invocations a per-invocation watcher registered —
        # unconditional inserts would grow the dict by one entry per
        # completion forever (group timers use the cancellable index)
        if inv.id in self._done:
            self._done[inv.id] = True
        group = self._groups.pop(inv.id, None)
        if group is not None:
            group[0] -= 1
            if group[0] <= 0:            # last member: drop the timer
                group[2].cancel()
                self.group_timers_cancelled += 1
                self._live_groups -= 1
                for iid in group[1]:
                    self._groups.pop(iid, None)
