"""Token data pipeline for the LM architectures (the port of
``src/repro/data/pipeline.py``).

A deterministic synthetic corpus: a Zipfian unigram-with-bigram-structure
stream (so losses actually *decrease* when the model learns), chunked
into (batch, seq) with next-token labels, prefetched by a host thread and
uploaded to the device.

The draws are the reference's, in the same order from the same numpy
generators, so both packages see the same tokens bit for bit.  One
difference of mechanism: each hidden state's emission and transition
CDFs are computed once (the same ``np.cumsum`` of the same rows), and a
token is the count of CDF entries below its uniform draw, found by
``np.searchsorted`` instead of a comparison over the whole vocabulary.
A CDF of positive terms never decreases, so the count is the same; at
qwen3's 151,936-token vocabulary this takes a 4 x 1024 batch from
seconds to milliseconds.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class TokenBatch:
    tokens: torch.Tensor   # (batch, seq) int32
    labels: torch.Tensor   # (batch, seq) int32 (next token)
    mask: torch.Tensor     # (batch, seq) float32


def _draw(cdf: np.ndarray, states: np.ndarray, u: np.ndarray) -> np.ndarray:
    """``(u[:, None] > cdf[states]).sum(axis=1)``, row by row."""
    return np.array([np.searchsorted(cdf[s], x, side="left")
                     for s, x in zip(states, u)], dtype=np.int64)


class SyntheticLMDataset:
    """Deterministic synthetic LM stream with learnable bigram structure."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 n_states: int = 64):
        self.vocab_size = vocab_size
        rng = np.random.default_rng(seed)
        self.n_states = n_states
        # Markov chain over hidden states, each state emits a Zipf slice.
        self.trans = rng.dirichlet(np.ones(n_states) * 0.2, size=n_states)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        zipf = 1.0 / ranks ** 1.1
        self.emit = np.stack([
            np.roll(zipf, rng.integers(vocab_size)) for _ in range(n_states)])
        self.emit /= self.emit.sum(axis=1, keepdims=True)
        self.emit_cdf = np.cumsum(self.emit, axis=1)
        self.trans_cdf = np.cumsum(self.trans, axis=1)

    def sample(self, rng: np.random.Generator, batch: int,
               seq: int) -> tuple[np.ndarray, np.ndarray]:
        states = rng.integers(self.n_states, size=batch)
        toks = np.empty((batch, seq + 1), np.int32)
        for t in range(seq + 1):
            # Categorical draws per row.
            u = rng.random(batch)
            toks[:, t] = _draw(self.emit_cdf, states, u)
            u2 = rng.random(batch)
            states = _draw(self.trans_cdf, states, u2)
        return toks[:, :-1], toks[:, 1:]


def make_lm_pipeline(vocab_size: int, batch: int, seq: int,
                     seed: int = 0, prefetch: int = 2, device="cuda",
                     ) -> Iterator[TokenBatch]:
    """Iterator of :class:`TokenBatch` on ``device``, drawn by a daemon
    host thread that keeps up to ``prefetch`` batches ready."""
    dev = resolve_device(device)
    ds = SyntheticLMDataset(vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)

    def producer():
        while True:
            toks, labels = ds.sample(rng, batch, seq)
            q.put((toks, labels))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()

    def batches():
        while True:
            toks, labels = q.get()
            yield TokenBatch(
                tokens=torch.from_numpy(np.ascontiguousarray(toks)).to(dev),
                labels=torch.from_numpy(np.ascontiguousarray(labels)).to(dev),
                mask=torch.ones((batch, seq), dtype=torch.float32,
                                device=dev))

    return batches()
