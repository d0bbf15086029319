"""Synthetic token data pipeline: seeded, shardable, restart-deterministic.

Counterpart of ``repro.train.data``, copied: numpy only, so the port's
batches are bit-equal to the reference's.

Produces packed LM batches (tokens, labels) from a Zipf unigram
distribution with document boundaries — enough structure for loss curves
to be meaningful (the model can learn the unigram + local bigram
statistics) while requiring no external data.

The iterator is stateless-resumable: batch i is a pure function of
(seed, i), so restart-from-checkpoint replays identically; each data
shard draws a disjoint stream (seed folded with shard index).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew
    mean_doc_len: int = 512
    bos_id: int = 0


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size)
        probs = 1.0 / ranks ** cfg.zipf_a
        self._probs = probs / probs.sum()

    def _doc(self, rng, n: int) -> np.ndarray:
        """A 'document': unigram draws with a persistent bigram shift."""
        base = rng.choice(np.arange(1, self.cfg.vocab_size), size=n,
                          p=self._probs)
        shift = rng.integers(1, 17)
        # every other token correlates with its predecessor (learnable)
        base[1::2] = (base[0::2][: len(base[1::2])] + shift) % (
            self.cfg.vocab_size - 1) + 1
        return base

    def batch(self, index: int, shard: int = 0, n_shards: int = 1) -> Dict:
        c = self.cfg
        rows = c.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, shard, index]))
        toks = np.empty((rows, c.seq_len + 1), np.int32)
        for r in range(rows):
            buf = []
            while sum(len(b) for b in buf) < c.seq_len + 1:
                n = max(8, int(rng.exponential(c.mean_doc_len)))
                buf.append(np.concatenate([[c.bos_id], self._doc(rng, n)]))
            row = np.concatenate(buf)[: c.seq_len + 1]
            toks[r] = row
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1
