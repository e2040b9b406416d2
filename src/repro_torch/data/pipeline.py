"""Deterministic data pipeline.

Production shape: a seeded, shardable synthetic token stream (documents with
zipfian token statistics and EOS-delimited boundaries) plus an optional
file-backed byte corpus. Each host reads only its slice of the global batch
(``host_index`` / ``host_count``), which is how the pipeline scales to
multi-pod launches; the returned arrays are the per-host shard of the global
batch.

The port's copy of the JAX package's ``data/pipeline.py``: NumPy only, so
the same ``DataConfig`` gives the same batches, byte for byte, in both
packages. The trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    mean_doc_len: int = 512
    eos_id: int = 0
    corpus_path: Optional[str] = None   # optional raw-byte corpus
    host_index: int = 0
    host_count: int = 1


class TokenStream:
    """Seeded zipfian document stream; deterministic per (seed, host, step)."""

    def __init__(self, dc: DataConfig):
        assert dc.global_batch % dc.host_count == 0
        self.dc = dc
        self.local_batch = dc.global_batch // dc.host_count
        self._corpus = None
        if dc.corpus_path:
            with open(dc.corpus_path, "rb") as f:
                raw = np.frombuffer(f.read(), np.uint8).astype(np.int32)
            self._corpus = raw % dc.vocab_size

    def _rng(self, step: int, row: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.dc.seed, self.dc.host_index * self.local_batch + row, step))

    def _row(self, step: int, row: int) -> np.ndarray:
        dc = self.dc
        rng = self._rng(step, row)
        if self._corpus is not None:
            start = int(rng.integers(0, max(len(self._corpus) - dc.seq_len
                                            - 1, 1)))
            return self._corpus[start:start + dc.seq_len + 1]
        out = np.empty(dc.seq_len + 1, np.int32)
        i = 0
        while i < dc.seq_len + 1:
            n = int(rng.geometric(1.0 / dc.mean_doc_len))
            n = min(n, dc.seq_len + 1 - i)
            # zipfian body, reserving id 0 for EOS
            body = rng.zipf(1.2, size=n - 1 if n > 1 else 0)
            body = (body % (dc.vocab_size - 1)) + 1
            out[i:i + n - 1] = body[:max(n - 1, 0)]
            if n >= 1:
                out[i + n - 1] = dc.eos_id
            i += n
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        dc = self.dc
        rows = np.stack([self._row(step, r) for r in range(self.local_batch)])
        tokens = rows[:, :-1]
        labels = rows[:, 1:]
        mask = (tokens != dc.eos_id).astype(np.float32)
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32), "mask": mask}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_request_stream(dc: DataConfig, mean_prompt: int = 128,
                        seed: int = 7) -> Iterator[np.ndarray]:
    """Inference-side: stream of variable-length prompts (serving engine)."""
    rng = np.random.default_rng(seed)
    while True:
        n = int(np.clip(rng.geometric(1.0 / mean_prompt), 4, dc.seq_len))
        yield (rng.integers(1, dc.vocab_size, n)).astype(np.int32)


def bursty_arrival_times(rate: float, duration_s: float, *,
                         burst_factor: float = 4.0,
                         period_s: float = 60.0,
                         seed: int = 11) -> np.ndarray:
    """Azure-functions-style bursty/diurnal arrivals (sorted seconds).

    A sinusoidal rate profile (1/burst_factor .. 1 of `rate*burst_factor`)
    sampled with a thinned Poisson process — the workload shape the FDN's
    EventModel forecasts and predictive prewarming are built for.
    """
    rng = np.random.default_rng(seed)
    peak = rate * burst_factor
    # oversample a homogeneous Poisson at the peak rate, then thin
    n = rng.poisson(peak * duration_s)
    t = np.sort(rng.uniform(0.0, duration_s, n))
    profile = 0.5 * (1 + np.sin(2 * np.pi * t / period_s))  # 0..1
    lam = rate * (1 + (burst_factor - 1) * profile)          # rate..peak
    keep = rng.uniform(0, 1, n) < lam / peak
    return t[keep]
