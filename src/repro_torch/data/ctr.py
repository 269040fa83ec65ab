"""Synthetic CTR datasets shaped like the paper's benchmarks.

The real Taobao/Avazu/Criteo logs are not available offline, so we generate
statistically-shaped analogs: Zipfian ID popularity (the regime where the
paper's alpha << 1 assumption holds), multi-hot ID fields, dense Non-ID
features, and a planted logistic ground truth so AUC is a meaningful,
monotone-in-training signal. Scales follow Table 1 of the paper (sparse
rows scaled down by a constant factor; Criteo-Syn keeps the paper's exact
row counts for the capacity dry-runs where nothing is materialised).

Batches carry ``ids`` of shape (B, n_fields, ids_per_field) with *per-field
local* id spaces: field ``i`` indexes its own ``rows_per_field``-row table
(matching the per-field tables that ``adapters.ctr_collection`` builds).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PlantedTruth:
    """The planted logistic ground truth behind a CTR stream: bucket
    effects over hashed ids + dense-feature effects, squashed through a
    sigmoid with a negative bias (~25% positives at bias=1.0).

    Shared by the offline sampler and the online click-feedback loop
    (repro.serving.feedback): both label examples from the SAME model, so
    a trainer fed served click feedback chases the same target as one fed
    the offline stream."""

    w_buckets: np.ndarray        # (n_fields, 256) hashed-id bucket effects
    w_dense: np.ndarray          # (max(n_dense,1), n_tasks)
    w_field: np.ndarray          # (n_fields, n_tasks)
    bias: float = 1.0            # prob = sigmoid(sig - bias)

    @staticmethod
    def from_seed(seed: int, n_fields: int, n_dense: int,
                  n_tasks: int = 1, bias: float = 1.0) -> "PlantedTruth":
        # draw order is load-bearing: it reproduces the pre-refactor
        # sampler's weights bit-for-bit from the same dataset seed
        truth = np.random.default_rng(seed)
        return PlantedTruth(
            w_buckets=truth.standard_normal((n_fields, 256))
            .astype(np.float32),
            w_dense=truth.standard_normal((max(n_dense, 1), n_tasks))
            .astype(np.float32),
            w_field=truth.standard_normal((n_fields, n_tasks))
            .astype(np.float32),
            bias=float(bias))

    @property
    def n_fields(self) -> int:
        return int(self.w_buckets.shape[0])

    @property
    def n_tasks(self) -> int:
        return int(self.w_field.shape[1])

    def prob(self, ids: np.ndarray, dense: np.ndarray | None = None
             ) -> np.ndarray:
        """True click probability for ``ids`` (B, n_fields, L) with -1
        padding and ``dense`` (B, >= w_dense rows) — (B, n_tasks)."""
        ids = np.asarray(ids, np.int64)
        F = self.n_fields
        mask = ids >= 0
        bucket = self.w_buckets[np.arange(F)[None, :, None],
                                np.where(mask, ids, 0) % 256]
        bucket = np.where(mask, bucket, 0.0)
        sig = (bucket.sum(-1) @ self.w_field) / np.sqrt(F)
        nd = self.w_dense.shape[0]
        if dense is None:
            dense = np.zeros((ids.shape[0], nd), np.float32)
        sig = sig + (np.asarray(dense, np.float32)[:, :nd]
                     @ self.w_dense) / np.sqrt(nd)
        return 1.0 / (1.0 + np.exp(-(sig - self.bias)))


@dataclass(frozen=True)
class CTRDataset:
    name: str
    n_rows: int                 # total embedding rows (sparse id space)
    n_fields: int               # ID-type feature fields
    ids_per_field: int          # multi-hot width
    n_dense: int                # Non-ID features
    n_tasks: int = 1
    zipf_a: float = 1.2         # popularity skew
    seed: int = 0

    @property
    def rows_per_field(self) -> int:
        """Rows of each field's own id space (per-field embedding table)."""
        from repro_torch.utils import default_field_rows
        return default_field_rows(self.n_rows, self.n_fields)

    def field_rows(self) -> tuple[int, ...]:
        """Per-field table row counts, in field order — feed this to
        ``adapters.ctr_collection(..., field_rows=...)``."""
        return (self.rows_per_field,) * self.n_fields

    def truth(self) -> PlantedTruth:
        """The dataset's planted logistic ground truth — keyed to the
        DATASET seed only, so every stream (offline sampler, online click
        feedback, any sample seed) labels from the same model."""
        return PlantedTruth.from_seed(self.seed, self.n_fields,
                                      self.n_dense, self.n_tasks)

    def sampler(self, batch_size: int, *, seed: int | None = None):
        """Infinite generator of batches (online-learning setting, no
        shuffling schema — paper §4.2.4).

        The planted logistic ground truth is keyed to the DATASET seed only
        — every stream (train, eval, any seed) shares one truth; `seed`
        varies just the samples drawn from it."""
        truth = self.truth()
        rng = np.random.default_rng(self.seed if seed is None else seed)
        rows_per_field = self.rows_per_field

        while True:
            # Zipf-ish ids: rejection-free bounded zipf via inverse-cdf approx
            u = rng.random((batch_size, self.n_fields, self.ids_per_field))
            ranks = np.floor(
                ((rows_per_field ** (1 - self.zipf_a) - 1) * u + 1)
                ** (1 / (1 - self.zipf_a)) - 1)
            ranks = np.clip(ranks, 0, rows_per_field - 1).astype(np.int64)
            # per-field LOCAL ids: each field indexes its own embedding
            # table from 0 (the multi-table EmbeddingCollection layout)
            ids = ranks
            # random multi-hot length: pad tail with -1
            lens = rng.integers(1, self.ids_per_field + 1,
                                (batch_size, self.n_fields))
            mask = (np.arange(self.ids_per_field)[None, None, :]
                    < lens[:, :, None])
            ids = np.where(mask, ids, -1)

            dense = rng.standard_normal((batch_size, max(self.n_dense, 1))) \
                .astype(np.float32)
            prob = truth.prob(ids, dense)                  # ~25% positives
            labels = (rng.random((batch_size, self.n_tasks)) < prob) \
                .astype(np.float32)
            batch = {"ids": ids.astype(np.int32),
                     "labels": labels}
            if self.n_dense:
                batch["dense"] = dense[:, : self.n_dense]
            yield batch


# Paper Table 1 scales (sparse rows scaled 1e-3 for the trainable analogs;
# Criteo-Syn rows are the paper's full counts — embedding rows = params/dim,
# dim=128 as in the paper's capacity test).
CTR_BENCHMARKS = {
    # paper: 29M sparse / 12M dense
    "taobao_ad": CTRDataset("taobao_ad", n_rows=29_000, n_fields=8,
                            ids_per_field=4, n_dense=8),
    # paper: 134M sparse
    "avazu_ad": CTRDataset("avazu_ad", n_rows=134_000, n_fields=16,
                           ids_per_field=4, n_dense=4),
    # paper: 540M sparse
    "criteo_ad": CTRDataset("criteo_ad", n_rows=540_000, n_fields=26,
                            ids_per_field=2, n_dense=13),
    # paper: 2T sparse / 34M dense, multi-task
    "kwai_video": CTRDataset("kwai_video", n_rows=2_000_000, n_fields=32,
                             ids_per_field=8, n_dense=16, n_tasks=4),
}


def criteo_syn_rows(trillions: float, dim: int = 128) -> int:
    """Criteo-Syn_k: embedding rows for a `trillions`-parameter table."""
    return int(trillions * 1e12) // dim


def make_ctr_dataset(name: str) -> CTRDataset:
    return CTR_BENCHMARKS[name]
