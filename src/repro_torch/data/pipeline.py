"""Deterministic synthetic data pipeline, the port's copy of
``repro.data.pipeline`` (NumPy, so batches are bitwise the reference's for
every ``(seed, host, step)``).

Counter-based PRNG keyed by (seed, host, step): any step's batch is
reproducible without replaying the stream, which is what makes
checkpoint/restart bitwise-verifiable and what a many-host deployment
needs (no shared iterator state to lose).

``RaggedBatcher`` produces variable-length sequence batches, the
irregular-scatter consumer (host -> devices scatterv).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.distributions import block_sizes


@dataclass
class SyntheticLM:
    """Markov-ish synthetic token stream with learnable structure (each
    token depends on the previous one), so a training run's loss visibly
    drops below the unigram entropy."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host: int = 0
    n_hosts: int = 1

    def batch(self, step: int) -> dict:
        assert self.global_batch % self.n_hosts == 0
        b_local = self.global_batch // self.n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host, step]))
        # order-1 structure: t_{i+1} = (a * t_i + noise) % vocab
        a = 31
        toks = np.empty((b_local, self.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, b_local)
        noise = rng.integers(0, 7, (b_local, self.seq_len))
        for i in range(self.seq_len):
            toks[:, i + 1] = (a * toks[:, i] + noise[:, i]) % self.vocab
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def host_shard(self, host: int, n_hosts: int) -> "SyntheticLM":
        return SyntheticLM(self.vocab, self.seq_len, self.global_batch,
                           self.seed, host, n_hosts)


@dataclass
class RaggedBatcher:
    """Variable-length sequences, padded per shard, with the true lengths
    reported — feeding the scatterv path and the MoE-style irregularity
    benchmarks.  Length profile = one of the paper's six distributions."""

    vocab: int
    n_shards: int
    avg_len: int
    profile: str = "random"
    seed: int = 0

    def batch(self, step: int):
        sizes = block_sizes(self.profile, self.n_shards, self.avg_len,
                            seed=self.seed + step)
        sizes = [max(1, s) for s in sizes]
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 7, step]))
        blocks = [rng.integers(0, self.vocab, (s,)).astype(np.int32)
                  for s in sizes]
        cap = max(sizes)
        padded = np.zeros((self.n_shards, cap), np.int32)
        for i, b in enumerate(blocks):
            padded[i, : sizes[i]] = b
        return padded, np.asarray(sizes, np.int32), blocks
