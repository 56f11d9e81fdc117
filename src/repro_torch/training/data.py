"""Deterministic, seekable data pipelines (the port of
``repro.training.data``).

Fault-tolerance contract: a batch is a pure function of (seed, step), so a
restart from checkpoint step N replays the exact stream a non-failed run
would have seen.  Both pipelines are host numpy, as in the reference, and
give the same batches bit for bit:

  * TokenPipeline — synthetic LM tokens (markov-ish for non-trivial loss).
  * GraphWalkPipeline — random walks over an extracted CSR graph, vertex
    ids as tokens: the paper's data plane feeding the compute plane.  It
    reads a host copy of the CSR's offsets and targets once.

As in the reference, a walk's first token is the start vertex unclipped
(only later tokens are clipped to ``vocab_size - 1``): over a graph with
more vertices than the vocabulary, a first token may lie outside the
vocabulary, and the model embeds it as NaN.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.relational.table import host


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # order-1 markov stream: next token depends on previous (learnable)
        base = rng.integers(0, self.vocab_size,
                            (self.batch, self.seq_len + 1), dtype=np.int64)
        drift = (base[:, :-1] * 31 + 17) % self.vocab_size
        coin = rng.random((self.batch, self.seq_len)) < 0.5
        toks = np.where(coin, drift, base[:, 1:]).astype(np.int32)
        first = base[:, :1].astype(np.int32)
        seq = np.concatenate([first, toks], axis=1)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


@dataclasses.dataclass
class GraphWalkPipeline:
    """Random walks over one edge label of an extracted graph."""

    csr: CSRGraph
    label: str
    batch: int
    seq_len: int
    seed: int = 0
    vocab_size: Optional[int] = None   # defaults to num_vertices

    def __post_init__(self):
        self.offsets = host(self.csr.offsets[self.label])
        self.targets = host(self.csr.targets[self.label])
        self.n = self.csr.num_vertices
        if self.vocab_size is None:
            self.vocab_size = self.n

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 7]))
        walks = np.zeros((self.batch, self.seq_len + 1), np.int32)
        cur = rng.integers(0, self.n, self.batch)
        walks[:, 0] = cur
        for t in range(1, self.seq_len + 1):
            lo = self.offsets[cur]
            hi = self.offsets[cur + 1]
            deg = hi - lo
            # dead ends teleport to a random vertex
            pick = lo + (rng.random(self.batch) * np.maximum(deg, 1)).astype(
                np.int64)
            nxt = np.where(deg > 0, self.targets[np.minimum(
                pick, len(self.targets) - 1)], rng.integers(0, self.n,
                                                            self.batch))
            nxt = np.clip(nxt, 0, self.vocab_size - 1)
            walks[:, t] = nxt
            cur = np.clip(nxt, 0, self.n - 1)
        return {"tokens": walks[:, :-1], "labels": walks[:, 1:]}
