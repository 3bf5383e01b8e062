"""Deterministic synthetic LM data: the port's own copy of
``repro.data.synthetic`` (numpy only), giving the same batches bit for
bit.

A counter-based generator (position-keyed, not sequential), so any
worker can materialise any batch index independently: batch ``i`` is
identical whoever builds it and whenever, which is what makes a restart
exact. The token stream is a Zipfian mixture with Markov and copy
structure, so losses decrease under training.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Full global batch for ``step`` (deterministic)."""
        return synthetic_batch(self.vocab, self.seq, self.global_batch,
                               step, self.seed)

    def shard(self, step: int, shard_idx: int, n_shards: int
              ) -> dict[str, np.ndarray]:
        """Rows [shard_idx::n_shards] of the global batch."""
        b = self.batch(step)
        return {k: v[shard_idx::n_shards] for k, v in b.items()}


def synthetic_batch(vocab: int, seq: int, batch: int, step: int,
                    seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # Markov chain over a Zipf-weighted vocab: learnable structure.
    base = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
    tokens = (base + np.arange(seq + 1)[None, :] * 31) % vocab
    # copy structure: the second half repeats the first half, shifted
    half = seq // 2
    tokens[:, half + 1:seq + 1] = tokens[:, 1:seq + 1 - half]
    tokens = tokens.astype(np.int32)
    return {"tokens": tokens[:, :seq], "labels": tokens[:, 1:seq + 1]}
