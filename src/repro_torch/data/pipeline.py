"""Deterministic synthetic LM data pipeline, a copy of the reference
package's ``data/pipeline.py`` (numpy, host-only): every batch is element
for element the reference's for the same ``(seed, step, process_index,
process_count)``.

Properties a 1000-node run needs:
  * deterministic: batch(step) is a pure function of (seed, step, host) — any
    host can recompute any batch, so restarts and elastic re-sharding never
    replay or skip data;
  * sharded: each host materializes only its slice (process_index/count);
  * checkpointable: the cursor (next step) is a tiny dict stored in the
    checkpoint.

The token stream is a mixture of Zipf-distributed unigrams and repeated
n-gram motifs, so small models have signal to fit (loss decreases) — used by
the end-to-end example and convergence tests.
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np


@dataclass
class DataState:
    step: int = 0

    def as_dict(self):
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]))


class SyntheticLMData:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1, motif_len: int = 8,
                 n_motifs: int = 64):
        assert global_batch % process_count == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // process_count
        self.seed = seed
        self.pidx = process_index
        rng = np.random.default_rng(seed)
        self.motifs = rng.integers(0, vocab_size,
                                   size=(n_motifs, motif_len)).astype(np.int32)
        # Zipf-ish unigram distribution
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.unigram = p / p.sum()

    def batch(self, step: int):
        """Returns dict(tokens (B,T) int32, labels (B,T) int32)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.pidx)
        B, T = self.local_batch, self.seq
        toks = rng.choice(self.vocab, size=(B, T + 1),
                          p=self.unigram).astype(np.int32)
        # stamp motifs: ~50% of positions covered by predictable n-grams
        n_stamp = max(1, (T // self.motifs.shape[1]) // 2)
        for b in range(B):
            for _ in range(n_stamp):
                m = self.motifs[rng.integers(len(self.motifs))]
                pos = rng.integers(0, T + 1 - len(m))
                toks[b, pos:pos + len(m)] = m
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
