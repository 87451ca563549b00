"""Deterministic sharded data pipeline (a copy of
``repro/data/pipeline.py``, numpy only; the batches are bit-equal to the
JAX package's for every ``(seed, step, shard, num_shards)``).

Synthetic LM data (Zipf-distributed tokens over n-gram templates so the
loss actually decreases), generated *per host shard*: each data-parallel
host materializes only its slice, keyed by (seed, step, shard) — which also
makes restart-exactness trivial (the iterator is a pure function of the
step counter restored from the checkpoint, no iterator state to persist)
and keeps elastic rescale correct (reshard = re-slice by new shard count).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The (host-local) batch for one step — pure function of step."""
        per_shard = self.global_batch // self.num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard])
        )
        # Markov-ish structure: tokens = base zipf + learnable bigram echo.
        v = self.vocab_size
        base = rng.zipf(1.3, size=(per_shard, self.seq_len + 1)).astype(np.int64)
        base = np.minimum(base, v - 1)
        echo = np.roll(base, 1, axis=1)
        mix = rng.random((per_shard, self.seq_len + 1)) < 0.35
        toks = np.where(mix, (echo * 7 + 11) % v, base).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch_iterator(data: SyntheticLMData, start_step: int = 0) -> Iterator:
    step = start_step
    while True:
        yield step, data.batch_at(step)
        step += 1
