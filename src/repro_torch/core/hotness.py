"""Decayed count-min hotness sketch — the admission filter of the
frequency-aware cache hierarchy (copy of ``repro/core/hotness.py``: numpy
only, the port imports nothing of ``repro``).

Persia's device cache (paper §4.2.2) is recency-only: every id seen once
claims a slot and can evict a genuinely hot row. ScaleFreeCTR's MixCache
(PAPERS.md) shows the production fix — track per-id access *frequency* in
sublinear space and only admit ids whose estimated hotness clears a
threshold; everything else is served from the lower tier without
disturbing the hot set.

The sketch here is a classic count-min (d hash rows, w counters each,
estimate = min over rows) with two recsys-specific twists:

* counters are float32 and *decayed* by a multiplicative factor every
  ``decay_every`` updates, so hotness is exponentially recent-weighted —
  an id that was hot yesterday but is cold now stops being admitted
  (the "decay forgets stale hotness" property ``tests/test_cache_tiers``
  pins);
* ``update`` takes the per-batch *unique* ids plus their occurrence
  counts (the :class:`~repro_torch.core.dedup.DedupPlan` hands both to the
  backend's prepare), so a once-per-batch update still counts true
  occurrence frequency, not post-dedup frequency.

Pure numpy, O(d) vectorized ops per batch; serializes to flat arrays so
it rides inside the host_lru checkpoint blob.
"""
from __future__ import annotations

import numpy as np

# affine-hash constants: odd multipliers (bijective premix mod 2^64),
# one (mult, add) pair drawn per sketch row from a seeded PCG stream
_MIX_SHIFT = 17


class HotnessSketch:
    """Decayed count-min sketch over int64 ids.

    >>> sk = HotnessSketch(width=1024, depth=4, decay=0.5, decay_every=64)
    >>> sk.update(np.array([3, 7]), counts=np.array([5, 1]))
    >>> sk.estimate(np.array([3, 7, 9]))     # ~[5, 1, 0]
    """

    def __init__(self, width: int = 4096, depth: int = 4,
                 decay: float = 0.5, decay_every: int = 256,
                 seed: int = 0):
        if width < 1 or depth < 1:
            raise ValueError(f"width/depth must be >= 1 "
                             f"(got {width}, {depth})")
        if not (0.0 < decay <= 1.0):
            raise ValueError(f"decay must be in (0, 1] (got {decay})")
        self.width = int(width)
        self.depth = int(depth)
        self.decay = float(decay)
        self.decay_every = max(int(decay_every), 1)
        self.seed = int(seed)
        rng = np.random.default_rng(seed)
        # odd multipliers => each row's premix is a bijection mod 2^64
        self._mult = (rng.integers(1, 2**63, self.depth,
                                   dtype=np.uint64) * 2 + 1)
        self._add = rng.integers(0, 2**63, self.depth, dtype=np.uint64)
        self.counts = np.zeros((self.depth, self.width), np.float32)
        self.updates = 0

    def _cols(self, ids: np.ndarray) -> np.ndarray:
        """(n,) ids -> (depth, n) counter columns."""
        u = np.asarray(ids, np.int64).astype(np.uint64)
        mixed = u[None, :] * self._mult[:, None] + self._add[:, None]
        # fold the high bits down before the mod: low bits of an affine
        # map over sequential ids are themselves sequential
        return ((mixed >> np.uint64(_MIX_SHIFT)) ^ mixed) % \
            np.uint64(self.width)

    # -- updates -------------------------------------------------------------

    def update(self, ids, counts=None) -> None:
        """Add one batch's occurrences: ``ids`` unique int64 ids (negatives
        ignored), ``counts`` their per-id occurrence counts (default 1)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        keep = ids >= 0
        ids = ids[keep]
        if counts is None:
            c = np.ones(ids.size, np.float32)
        else:
            c = np.asarray(counts, np.float32).reshape(-1)[keep]
        if ids.size:
            cols = self._cols(ids)
            for d in range(self.depth):
                np.add.at(self.counts[d], cols[d], c)
        self.updates += 1
        if self.updates % self.decay_every == 0:
            self.age()

    def age(self) -> None:
        """Apply one decay step (also called automatically every
        ``decay_every`` updates): hotness is exponentially
        recent-weighted, so stale ids fall back below the admission
        threshold instead of staying 'hot' forever."""
        if self.decay < 1.0:
            self.counts *= self.decay
            # flush denormals so a long-idle sketch reads exactly cold
            self.counts[self.counts < 1e-6] = 0.0

    # -- queries -------------------------------------------------------------

    def estimate(self, ids) -> np.ndarray:
        """(n,) float32 count-min estimates (upper bounds; negatives
        estimate 0)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return np.zeros(0, np.float32)
        cols = self._cols(np.where(ids >= 0, ids, 0))
        est = self.counts[np.arange(self.depth)[:, None], cols].min(axis=0)
        return np.where(ids >= 0, est, 0.0).astype(np.float32)

    # -- (de)serialisation ---------------------------------------------------

    def serialize(self) -> dict[str, np.ndarray]:
        return {
            "counts": self.counts.copy(),
            "meta": np.array([self.width, self.depth, self.decay_every,
                              self.seed, self.updates], np.int64),
            "decay": np.array([self.decay], np.float64),
        }

    @classmethod
    def deserialize(cls, blob) -> "HotnessSketch":
        meta = [int(x) for x in np.asarray(blob["meta"]).reshape(-1)]
        width, depth, decay_every, seed, updates = meta[:5]
        sk = cls(width=width, depth=depth,
                 decay=float(np.asarray(blob["decay"]).reshape(-1)[0]),
                 decay_every=decay_every, seed=seed)
        sk.counts[...] = np.asarray(blob["counts"],
                                    np.float32).reshape(depth, width)
        sk.updates = updates
        return sk
