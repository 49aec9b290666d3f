"""Deterministic synthetic data pipeline with prefetch: the JAX package's
``training/data.py`` (numpy only), batch for batch the same stream.

Stateless batch addressing — batch_at(step) is a pure function of
(seed, step) — makes the pipeline trivially checkpointable and elastic:
restoring on a different data-parallel layout only needs the step counter
(saved in the checkpoint manifest). A background-thread prefetcher overlaps
host batch synthesis with device compute, the host-side half of
compute/comm overlap.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLM:
    """Zipf-ish token stream → (tokens, targets) pairs."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, extras: Optional[Dict[str, tuple]] = None):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.extras = extras or {}

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        # zipf-like marginal: heavy head, long tail (more realistic than
        # uniform for embedding-gather behaviour)
        u = rng.random((self.batch, self.seq + 1))
        toks = np.minimum((self.vocab * u ** 2.2).astype(np.int64),
                          self.vocab - 1).astype(np.int32)
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        for name, (shape, dtype) in self.extras.items():
            out[name] = rng.standard_normal((self.batch,) + shape).astype(dtype)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of up to `depth` batches."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self.q.put(source.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def next(self) -> Dict[str, np.ndarray]:
        return self.q.get()

    def close(self):
        self._stop.set()
