"""Deterministic discrete-event clock.

One CPU core has to impersonate five target platforms, so every latency in
the FDN (queueing, cold starts, execution, data transfer) is advanced on
this clock. Small functions can still *really* execute (jitted on CPU) to
calibrate the analytic costs — see platform.ExecutionModel.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Optional, Tuple


class TimerHandle:
    """Cancellation token for a scheduled callback.

    ``cancel`` drops the callback reference immediately (the closure and
    everything it captures become collectable right away); the heap entry
    itself is skipped silently when its time comes.  Cancelled timers are
    therefore "dropped", not "fired as no-ops"."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], None]):
        self.fn: Optional[Callable[[], None]] = fn

    def cancel(self) -> None:
        self.fn = None

    @property
    def cancelled(self) -> bool:
        return self.fn is None

    def __call__(self) -> None:
        if self.fn is not None:
            self.fn()


class SimClock:
    def __init__(self):
        self._t = 0.0
        self._q: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()

    def now(self) -> float:
        return self._t

    def schedule(self, t: float, fn: Callable[[], None]) -> None:
        assert t >= self._t - 1e-9, (t, self._t)
        heapq.heappush(self._q, (t, next(self._seq), fn))

    def schedule_cancellable(self, t: float,
                             fn: Callable[[], None]) -> TimerHandle:
        """Like ``schedule`` but returns a handle whose ``cancel`` drops
        the callback (hedge group timers whose members all completed)."""
        handle = TimerHandle(fn)
        self.schedule(t, handle)
        return handle

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.schedule(self._t + max(dt, 0.0), fn)

    def after_cancellable(self, dt: float,
                          fn: Callable[[], None]) -> TimerHandle:
        return self.schedule_cancellable(self._t + max(dt, 0.0), fn)

    def schedule_many(self, times, fns) -> None:
        """Bulk-schedule parallel sequences of times and callbacks (one
        validation for the whole batch — used by the open-loop load
        generator, which enqueues thousands of window events at once)."""
        times = list(times)
        if not times:
            return
        assert min(times) >= self._t - 1e-9, (min(times), self._t)
        q, seq = self._q, self._seq
        for t, fn in zip(times, fns):
            heapq.heappush(q, (t, next(seq), fn))

    def step(self) -> bool:
        if not self._q:
            return False
        t, _, fn = heapq.heappop(self._q)
        self._t = max(self._t, t)
        fn()
        return True

    def run_until(self, t_end: float) -> None:
        while self._q and self._q[0][0] <= t_end:
            self.step()
        self._t = max(self._t, t_end)

    def run(self) -> None:
        while self.step():
            pass

    @property
    def pending(self) -> int:
        return len(self._q)
