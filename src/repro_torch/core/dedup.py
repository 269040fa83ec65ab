"""Worker-side batch deduplication (port of ``repro/core/dedup.py``,
Persia §4.2.3).

A CTR batch's multi-hot ids repeat heavily, so the worker reads one row per
*unique* id. The :class:`DedupPlan` is computed once per (table, batch) on
the host and carries ``dev`` (the unique ids as device rows, padded with -1
to a power-of-two bucket) and ``inv`` (occurrence -> position in ``dev``,
-1 for padding). ``make_plan`` is the JAX package's numpy code, copied, so
both packages build identical plans from identical ids.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils import round_up


def dedup_cap(n_put: int, n_rows: int) -> int:
    """Capacity of a deduplicated put of ``n_put`` entries over an id space
    of ``n_rows``: at most ``min(n_put, n_rows)`` rows can be distinct,
    rounded up so the deduped arrays still shard over the batch axes on any
    production mesh (up to 1024 batch shards). Idempotent."""
    n_put = int(n_put)
    return round_up(min(n_put, int(n_rows)), min(1024, max(n_put, 1)))


def pow2_bucket(n: int, floor: int = 32) -> int:
    """Smallest power of two >= n (and >= floor): the shape-stability
    bucket of a plan's unique width."""
    b = floor
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass
class DedupPlan:
    """One batch's unique-width routing for one table.

    ``dev``: (U,) int32 unique *device* rows, -1 padding.
    ``inv``: occurrence-shaped int32, occurrence -> position in ``dev``
    (-1 for padding / out-of-range occurrences).
    """
    dev: torch.Tensor
    inv: torch.Tensor


def is_plan(x) -> bool:
    return isinstance(x, DedupPlan)


def make_plan(ids, n_rows: int, cap: int, floor: int = 32):
    """Host-side dedup of one table's batch ids.

    ids: any-shape int array, -1 (or out-of-range) = padding.
    Returns ``(unique_ids, inverse, counts, info)``:

    * ``unique_ids``: (bucket,) np.int64, sorted uniques padded with -1
      (``bucket = min(pow2_bucket(n_unique, floor), cap)``);
    * ``inverse``: ids-shaped np.int32, occurrence -> unique position
      (-1 for invalid occurrences);
    * ``counts``: (bucket,) np.int64 occurrence count per unique id (0 on
      padding);
    * ``info``: {n_unique, n_occ, dup_factor} host gauges.
    """
    arr = np.asarray(ids, np.int64)
    flat = arr.reshape(-1)
    valid = (flat >= 0) & (flat < int(n_rows))
    uniq, inv_valid, cnt = np.unique(flat[valid], return_inverse=True,
                                     return_counts=True)
    bucket = min(pow2_bucket(max(int(uniq.size), 1), floor), int(cap))
    if uniq.size > bucket:
        raise ValueError(
            f"batch working set ({uniq.size} unique ids) exceeds this "
            f"table's dedup capacity ({bucket} — bounded by the occurrence "
            "count and the table rows) — shrink the batch")
    u_pad = np.full(bucket, -1, np.int64)
    u_pad[: uniq.size] = uniq
    counts = np.zeros(bucket, np.int64)
    counts[: uniq.size] = cnt
    inv = np.full(flat.shape, -1, np.int32)
    inv[valid] = inv_valid.astype(np.int32)
    n_occ = int(valid.sum())
    info = {"n_unique": int(uniq.size), "n_occ": n_occ,
            "dup_factor": n_occ / max(int(uniq.size), 1)}
    return u_pad, inv.reshape(arr.shape), counts, info


def plan_scatter(acts_u: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Unique-width activations -> occurrence-width activations.

    acts_u: (U, D); inv: occurrence-shaped int -> (*inv.shape, D) with
    zero rows for invalid occurrences (inv < 0)."""
    flat = inv.reshape(-1)
    safe = flat.clamp(0, acts_u.shape[0] - 1).long()
    out = torch.where((flat >= 0)[:, None], acts_u[safe], 0)
    return out.reshape(*inv.shape, acts_u.shape[-1])
