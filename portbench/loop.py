"""The open loop that drives the program's serving engine through a run.

Each pass submits every request that is due, calls ``ServingEngine.step()``
and stamps every token that call delivered with the client's clock
(``time.perf_counter``), read after ``step()`` returns: ``step()`` ends in a
host copy of the tokens, so they are on the host by then. A request is
timed from when it was due, not from when the loop got round to
submitting it.

The window opens at the first step return after the ramp and closes at the
first step return ``seconds`` later. After the close the loop keeps serving
the schedule until every request due in the window has its first token, or
``traffic.DRAIN_S`` has passed.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from portbench.traffic import DRAIN_S, Due


@dataclass
class Track:
    """What the client saw of one request."""
    due: Due
    due_t: float                       # absolute due time (client clock)
    submit_t: Optional[float] = None
    stamps: List[float] = field(default_factory=list)
    req: object = None                 # the engine's Request


@dataclass
class Step:
    """One ``step()`` call: when it began and returned, the prompt lengths
    it admitted, and each active decode row's live keys."""
    t0: float
    t1: float
    prefills: List[int]
    keys: List[int]


@dataclass
class Served:
    tracks: List[Track]
    steps: List[Step]
    open_t: float
    close_t: float
    end_t: float
    window_due: List[Track]
    drained: bool = True
    hooks: Dict[str, object] = field(default_factory=dict)


def serve(engine, make_request: Callable[[Due], object],
          schedule: List[Due], ramp_s: float, seconds: float,
          hooks: Optional[Dict[str, Callable]] = None) -> Served:
    """Run the schedule through ``engine``. ``hooks`` may hold ``open``,
    ``close`` (called at the window's edges, returning a value kept under
    that name) and ``loop`` (a context manager factory wrapped around each
    pass, for the trace)."""
    hooks = hooks or {}
    clock = time.perf_counter
    loop_ctx = hooks.get("loop")
    tracks: List[Track] = []
    by_req: Dict[int, Track] = {}
    steps: List[Step] = []
    kept: Dict[str, object] = {}
    ramp_t = clock()
    open_t = close_t = None
    nxt = 0
    n = len(schedule)

    def slot_tracks():
        return [by_req[id(r)] for r in engine.slots if r is not None]

    while True:
        ctx = loop_ctx() if loop_ctx is not None else None
        if ctx is not None:
            ctx.__enter__()
        try:
            now = clock()
            while nxt < n and ramp_t + schedule[nxt].due_s <= now:
                due = schedule[nxt]
                tr = Track(due, ramp_t + due.due_s, now)
                tr.req = make_request(due)
                by_req[id(tr.req)] = tr
                tracks.append(tr)
                engine.submit(tr.req)
                nxt += 1
            before = slot_tracks()
            if before or engine.queue:
                t0 = clock()
                engine.step()
                t1 = clock()
                after = slot_tracks()
                prefills, keys = [], []
                for tr in {id(t): t for t in before + after}.values():
                    got = len(tr.req.out_tokens)
                    new = got - len(tr.stamps)
                    if new <= 0:
                        continue
                    if not tr.stamps:
                        prefills.append(len(tr.due.prompt))
                    tr.stamps.extend([t1] * new)
                    keys.append(len(tr.due.prompt) + got - 1)
                steps.append(Step(t0, t1, prefills, keys))
                now = t1
            elif nxt < n:
                time.sleep(max(0.0, min(ramp_t + schedule[nxt].due_s - now,
                                        0.01)))
                now = clock()
            else:
                time.sleep(0.001)
                now = clock()
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
        if open_t is None and now >= ramp_t + ramp_s:
            open_t = now
            if "open" in hooks:
                kept["open"] = hooks["open"]()
        elif open_t is not None and close_t is None \
                and now >= open_t + seconds:
            close_t = now
            if "close" in hooks:
                kept["close"] = hooks["close"]()
        if "tick" in hooks and open_t is not None:
            hooks["tick"](now)
        if close_t is not None:
            window_due = [t for t in tracks
                          if open_t <= t.due_t < open_t + seconds]
            waiting = any(not t.stamps for t in window_due)
            if not waiting or now > close_t + DRAIN_S:
                return Served(tracks, steps, open_t, close_t, now,
                              window_due, drained=not waiting, hooks=kept)
        if nxt >= n and not engine.queue and not any(
                s is not None for s in engine.slots) and open_t is None:
            raise RuntimeError("the schedule ran out before the window "
                               "opened")


def lateness_s(served: Served) -> np.ndarray:
    """How late the loop submitted each request past its due time."""
    return np.array([t.submit_t - t.due_t for t in served.tracks
                     if t.submit_t is not None])
