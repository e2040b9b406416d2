"""Continuous-batching serving engine, ported from the JAX package's
``serving/engine.py`` with the same admission, bucketing, continuous batching
and ``stats()``.

A fixed decode batch of B slots over a shared KV cache; finished slots are
refilled from the waiting queue without stopping the other rows (per-row
cache positions — see models/transformer.cache_specs). Prefill runs at
bucketed prompt lengths, and the resulting single-request cache is written
into the live batch cache.

The engine runs where its parameters lie. The batch cache is updated IN
PLACE: ``_insert_cache`` writes a new request's cache into its slot, and a
decode step writes one k/v row per attention layer (and, for the SSM family,
its states) in place (models/*.decode_step).

Admission, each prefill, the decode step and the retirement of its tokens
are ``torch.profiler`` ranges (``engine.admit``, ``engine.prefill``,
``engine.decode_step``, ``engine.retire``; ``repro_torch.ranges``), opened
only while a profiler runs. launch/trace_serve.py reads them all, the
benchmark's ``portbench/trace.py`` the prefill and decode step ranges.

A request is stamped on the engine's clock when it is submitted, admitted
(popped from the queue), given its first token and done; the default clock
is ``time.perf_counter``, the clock a caller's own stamps are usually on.
``stats()`` counts, where the decode batch is built and on the host alone,
the live keys of every decode step's active rows (``keys_live``); a step's
attention reads ``cap`` keys in each of its B rows, so the share of keys
that are not padding is ``keys_live / (decode_steps * B * cap)``.
launch/trace_serve.py reports that share and the queue wait
(``admitted_s - submitted_s``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import HYBRID, ModelConfig
from repro_torch.models import model_api as api
from repro_torch.ranges import ranged


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    submitted_s: float = 0.0
    admitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.done_s is not None


def _buckets(max_len: int) -> List[int]:
    out, b = [], 16
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, batch_size: int = 4,
                 max_context: int = 256, greedy: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.B = batch_size
        self.max_context = max_context
        self.clock = clock
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.specs = api.cache_specs(cfg, batch_size, max_context)
        self.cache = api.init_cache(cfg, batch_size, max_context,
                                    device=self.device)
        self._steps = 0
        self._generated = 0
        # keys a decode step's attention reads in each row (0: no k/v cache)
        self.cap = self.specs["k_pos"].shape[1] if "k_pos" in self.specs \
            else 0
        self._keys_live = 0
        # each slot's cache position after its prefill: the prompt's length,
        # or the bucket's where prefill runs the pad tokens through (hybrid)
        self._slot_start = [0] * batch_size
        self.buckets = _buckets(max_context)
        self._slot_tokens = np.zeros((batch_size, 1), np.int32)

    # ------------------------------------------------------------ intake --
    def submit(self, req: Request):
        req.submitted_s = self.clock()
        self.queue.append(req)

    def _bucket_len(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @torch.inference_mode()
    def _admit(self):
        if not self.queue or all(r is not None for r in self.slots):
            return
        with ranged("engine.admit"):
            for slot in range(self.B):
                if self.slots[slot] is not None or not self.queue:
                    continue
                req = self.queue.popleft()
                req.admitted_s = self.clock()
                n = len(req.prompt)
                pad = self._bucket_len(n)
                tokens = np.zeros((1, pad), np.int64)
                tokens[0, :n] = req.prompt
                batch = {"tokens": torch.from_numpy(tokens).to(self.device),
                         "prompt_lens": torch.tensor(
                             [n], dtype=torch.int32, device=self.device)}
                with ranged("engine.prefill"):
                    logits, small = api.prefill(self.cfg, self.params, batch,
                                                self.max_context)
                tok = int(torch.argmax(logits[0, -1]))
                self._insert_cache(slot, small)
                self._slot_start[slot] = pad if self.cfg.family == HYBRID \
                    else n
                req.out_tokens.append(tok)
                req.first_token_s = self.clock()
                self._slot_tokens[slot, 0] = tok
                self.slots[slot] = req

    def _insert_cache(self, slot: int, small: Dict):
        """Write a batch=1 cache into batch slot ``slot``, in place, casting
        to the live cache's dtype. Each leaf's batch axis is where its
        ``Spec`` in ``api.cache_specs`` names "batch": axis 1 of the
        layer-stacked leaves (k/v, SSM and RG-LRU states), axis 0 of the
        batch-leading ones (k_pos, pos, the hybrid's tail states). The JAX
        engine guesses the axis by shape instead."""
        def ins(spec, big, one):
            if isinstance(spec, dict):
                for k in spec:
                    ins(spec[k], big[k], one[k])
                return
            ax = spec.axes.index("batch")
            big.select(ax, slot).copy_(one.select(ax, 0))

        ins(self.specs, self.cache, small)

    # ------------------------------------------------------------- churn --
    @torch.inference_mode()
    def step(self) -> int:
        """One engine iteration: admit, decode, retire. Returns #active."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        self._count_batch(active)
        batch = {"token": torch.from_numpy(
            self._slot_tokens.astype(np.int64)).to(self.device)}
        with ranged("engine.decode_step"):
            logits, self.cache = api.decode_step(self.cfg, self.params,
                                                 self.cache, batch)
        self._steps += 1
        with ranged("engine.retire"):
            toks = torch.argmax(logits[:, 0, :], dim=-1).to(
                torch.int32).cpu().numpy()
            for i in active:
                req = self.slots[i]
                tok = int(toks[i])
                req.out_tokens.append(tok)
                self._generated += 1
                self._slot_tokens[i, 0] = tok
                hit_eos = req.eos_id is not None and tok == req.eos_id
                if hit_eos or len(req.out_tokens) >= req.max_new_tokens:
                    req.done_s = self.clock()
                    self.slots[i] = None   # slot freed; next step refills
        return len(active)

    def _count_batch(self, active: List[int]):
        """Count one decode batch's live keys: each active row's prefill
        keys, the tokens decoded so far and the one this step writes,
        capped at ``cap``."""
        self._keys_live += sum(
            min(self._slot_start[i] + len(self.slots[i].out_tokens),
                self.cap) for i in active)

    def run(self, requests: List[Request], max_steps: int = 10_000
            ) -> List[Request]:
        for r in requests:
            self.submit(r)
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return requests

    # ------------------------------------------------------------ stats ---
    def stats(self) -> Dict[str, float]:
        return {"decode_steps": self._steps,
                "tokens_generated": self._generated,
                "slot_utilization": self._generated /
                max(self._steps * self.B, 1),
                "keys_live": self._keys_live}
