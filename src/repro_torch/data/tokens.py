"""Deterministic synthetic token pipeline for LM training.

Design mirrors a production loader: the stream is addressed by (step, shard)
so any host can regenerate exactly its shard for any step — restart after a
failure needs no loader state in the checkpoint beyond the step counter, and
elastic rescaling (different shard count) re-partitions deterministically.

Tokens follow a Zipf-ish unigram draw mixed with short repeated motifs so a
model can actually reduce loss (tests train a ~1M-param model on it).
"""

from __future__ import annotations

import numpy as np

__all__ = ["TokenStream"]


class TokenStream:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, num_shards: int = 1, shard: int = 0):
        assert global_batch % num_shards == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.num_shards = num_shards
        self.shard = shard
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = p / p.sum()

    def batch(self, step: int) -> np.ndarray:
        """(local_batch, seq) int32, deterministic in (seed, step, shard)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard)
        toks = rng.choice(self.vocab, size=(self.local_batch, self.seq),
                          p=self._p).astype(np.int32)
        # plant motifs: short ngrams repeated later in the sequence, giving
        # in-context structure (loss below unigram entropy is learnable)
        max_motif = min(12, max(self.seq // 4, 2))
        for b in range(self.local_batch):
            n_motif = rng.integers(2, 6)
            for _ in range(n_motif):
                L = int(rng.integers(2, max_motif)) if max_motif > 2 else 2
                if self.seq - 2 * L <= 0 or self.seq - L <= 0:
                    continue
                src = int(rng.integers(0, self.seq - 2 * L))
                dst = int(rng.integers(src + L, self.seq - L))
                toks[b, dst:dst + L] = toks[b, src:src + L]
        return toks
