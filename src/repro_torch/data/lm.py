"""Synthetic LM token streams (copy of ``repro/data/lm.py``; numpy only):
a small Markov-chain language over the vocab gives next-token structure
(so loss visibly decreases), generated on the fly."""
from __future__ import annotations

import numpy as np


def lm_batches(vocab_size: int, batch: int, seq_len: int, *, seed: int = 0,
               order: int = 1, branch: int = 16):
    """Infinite generator of {'tokens', 'targets', 'mask'} batches.

    Each token's successor is drawn from `branch` allowed continuations
    (a sparse deterministic transition structure + noise), so a model can
    reach low loss by learning the table.
    """
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab_size, size=(vocab_size, branch))
    while True:
        toks = np.empty((batch, seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, vocab_size, size=batch)
        for t in range(seq_len):
            pick = rng.integers(0, branch, size=batch)
            nxt = succ[toks[:, t], pick]
            noise = rng.random(batch) < 0.05
            nxt = np.where(noise, rng.integers(0, vocab_size, batch), nxt)
            toks[:, t + 1] = nxt
        yield {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "mask": np.ones((batch, seq_len), np.float32),
        }
