"""Data pipeline: token streams with background prefetch, as the JAX
package's `repro/data/pipeline.py`.

  * `SyntheticLM` — deterministic per-(step, host) seeded token batches,
    bit-identical to the JAX package's for the same seed and step (numpy,
    the same rng formula).
  * `MemmapTokens` — flat binary int32 token file (np.memmap), contiguous
    windows strided over hosts.

One card is one host: host 0 of 1 unless the caller says otherwise.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    """Deterministic synthetic next-token data (shifted-sequence labels)."""

    def __init__(self, vocab_size: int, seq_len: int, batch_per_host: int,
                 seed: int = 0, structured: bool = False):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_per_host
        self.seed = seed
        self.structured = structured

    def batch_at(self, step: int, host: int = 0) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4099 + host)
        if self.structured:
            # learnable sequences: t_{i+1} = (t_i + stride) mod V with a
            # small stride alphabet — loss visibly drops below log(V)
            start = rng.integers(0, self.vocab, (self.batch, 1))
            stride = rng.choice([1, 2, 3, 5, 7], (self.batch, 1))
            idx = np.arange(self.seq + 1)[None]
            toks = ((start + stride * idx) % self.vocab).astype(np.int32)
        else:
            toks = rng.integers(0, self.vocab,
                                size=(self.batch, self.seq + 1),
                                dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapTokens:
    """Flat int32 token file; contiguous windows strided over hosts."""

    def __init__(self, path: str, seq_len: int, batch_per_host: int,
                 n_hosts: int = 1, host: int = 0):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.seq = seq_len
        self.batch = batch_per_host
        self.n_hosts = n_hosts
        self.host = host
        self.n_windows = (len(self.data) - 1) // seq_len

    def batch_at(self, step: int) -> dict:
        idx = (step * self.n_hosts + self.host) * self.batch
        rows = [(idx + i) % self.n_windows for i in range(self.batch)]
        toks = np.stack([self.data[r * self.seq:(r + 1) * self.seq + 1]
                         for r in rows]).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch: overlaps host data prep with the
    device step."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.it = it
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for item in self.it:
                if self._stop.is_set():
                    return
                self.q.put(item)
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass
