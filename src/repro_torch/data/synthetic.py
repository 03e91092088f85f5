"""Deterministic synthetic LM data (a copy of ``repro/data/synthetic.py``,
which is numpy only, but importing ``repro.data`` pulls in JAX through
``repro/__init__.py``).  Its batches are equal bit for bit to the JAX
package's (a test pins it).

Zipfian unigram draws (echoing the paper's §3.1 observation that real-world
token distributions follow Zipf's law — the very redundancy LSH-MoE
exploits) mixed with short deterministic motifs so models have learnable
structure.  Sharded by (host, step): every (step, shard) pair regenerates
identically, which makes checkpoint-restart bit-exact without storing data
state beyond the step counter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard: int = 0
    zipf_a: float = 1.3
    motif_len: int = 8

    def __post_init__(self):
        self.local_batch = self.global_batch // self.num_shards
        v = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = 1.0 / np.power(v, self.zipf_a)
        self._probs = p / p.sum()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        B, S = self.local_batch, self.seq_len
        toks = rng.choice(self.vocab_size, size=(B, S + 1),
                          p=self._probs).astype(np.int32)
        # plant motifs: next-token-predictable runs (learnable signal)
        n_motifs = max(1, S // (4 * self.motif_len))
        for b in range(B):
            starts = rng.integers(0, S - self.motif_len, size=n_motifs)
            base = rng.integers(0, max(1, self.vocab_size - self.motif_len))
            for s in starts:
                toks[b, s:s + self.motif_len] = base + np.arange(self.motif_len)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
