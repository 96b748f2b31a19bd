"""Deterministic synthetic LM data pipeline (a verbatim copy of
``src/repro/data/pipeline.py``: pure numpy, so batches are bit-identical to
the reference's for every ``(seed, shard, step)``).

Mimics a production sharded-file reader: the global token stream is split
into `num_shards` deterministic shards (one per data-parallel host group);
each shard produces (tokens, labels) batches independently, so restarts and
elastic reshards can reproduce the exact stream from (seed, shard, step).

The synthetic "language" is a order-1 Markov chain over the vocab with a
few high-probability loops — enough structure that a model's loss visibly
drops during the example training runs (pure uniform noise would not).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticTextDataset:
    vocab: int
    seq_len: int
    batch: int                 # per-shard batch
    seed: int = 0
    num_shards: int = 1
    shard: int = 0

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for (shard, step) — restart-reproducible."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.shard) * 1_000_003 + step
        )
        B, S, V = self.batch, self.seq_len, self.vocab
        # markov-ish stream: next = (cur * a + noise) % V with sticky loops
        cur = rng.integers(0, V, size=(B, 1))
        toks = [cur]
        a = 6364136223846793005 % V or 1
        for _ in range(S):
            stay = rng.random((B, 1)) < 0.3
            nxt = np.where(
                stay, (cur + 1) % V,
                (cur * a + rng.integers(0, max(V // 16, 2), size=(B, 1))) % V,
            )
            toks.append(nxt)
            cur = nxt
        seq = np.concatenate(toks, axis=1)
        return {
            "tokens": seq[:, :S].astype(np.int32),
            "labels": seq[:, 1:S + 1].astype(np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_train_iterator(vocab: int, seq_len: int, batch: int, *, seed: int = 0,
                        num_shards: int = 1, shard: int = 0, start_step: int = 0):
    ds = SyntheticTextDataset(vocab, seq_len, batch, seed, num_shards, shard)
    step = start_step
    while True:
        yield step, ds.batch_at(step)
        step += 1
