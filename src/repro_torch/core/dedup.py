"""Worker-side batch deduplication (port of ``repro/core/dedup.py``,
Persia §4.2.3).

A CTR batch's multi-hot ids repeat heavily, so the worker reads one row per
*unique* id. The :class:`DedupPlan` is computed once per (table, batch) on
the host and carries ``dev`` (the unique ids as device ids, padded with -1
to a power-of-two bucket) and ``inv`` (occurrence -> position in ``dev``,
-1 for padding). ``make_plan`` is the JAX package's numpy code, copied, so
both packages build identical plans from identical ids.

The port's plan also carries what the CUDA kernels read: the physical
table rows of ``dev`` (``rows``, for the ``unique_bag`` lookup) and the
occurrence CSR (``order``/``offsets``, for the ``fused_backward`` put),
all built on the host beside the plan and uploaded with it. The CSR lets
the put sum each unique id's occurrence gradients in occurrence order —
the order of the JAX package's scatter-add — without atomics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as K
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

    ``dev``: (U,) int32 unique *device* ids (the logical ids, for the
    dense backend; cache slots, for host_lru), -1 padding.
    ``inv``: occurrence-shaped int32, occurrence -> position in ``dev``
    (-1 for padding / out-of-range occurrences).
    ``rows``: (U,) int32 table rows of ``dev`` (the backend's
    ``table_rows``: the shuffled rows, or the slots themselves), -1
    padding.
    ``order``/``offsets``: the occurrence CSR of ``inv``
    (:func:`occurrence_csr`).
    ``n_unique``: the host count of the valid entries of ``dev``.
    ``host``: the host int32 array that was uploaded as ``dev`` (slot
    pinning reads it, so a pin waits for no device).
    ``shards``: for a table of the sharded router, its
    :class:`ShardParts` (then ``rows`` is None: the router has no one
    table).
    ``ids``: for a host_lru table under a mesh, the (U,) int32 logical
    ids of ``dev``'s slots (the mesh put dedups and queues by them).
    The last seven are built by ``backend.prepare_all``; a plan made by
    hand may leave them ``None``.
    """
    dev: torch.Tensor
    inv: torch.Tensor
    rows: torch.Tensor | None = None
    order: torch.Tensor | None = None
    offsets: torch.Tensor | None = None
    n_unique: int | None = None
    host: np.ndarray | None = None
    shards: "ShardParts | None" = None
    ids: torch.Tensor | None = None


@dataclasses.dataclass
class ShardParts:
    """A sharded-router plan's per-shard index arrays, built on the host
    beside the plan. ``rows[s]``: the table rows of shard ``s``'s entries
    of ``dev``, in position order; ``perm``: (U,) position -> row of the
    concatenation of the shards' gathered rows and one zero row (padding
    reads the zero row), so one gather puts every unique row at its plan
    position; ``local[s]``: (U,) shard ``s``'s local device ids, -1 at the
    positions other shards own (the put's per-shard ids)."""
    perm: torch.Tensor
    rows: tuple
    local: tuple


def is_plan(x) -> bool:
    return isinstance(x, DedupPlan)


def plan_dev(x):
    """The device-id array of a plan, or the array itself (host-side
    callers, such as slot pinning, that accept either form)."""
    return x.dev if isinstance(x, DedupPlan) else x


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
            "count, the table rows and, for host-backed tables, the device "
            "cache) — raise EmbeddingSpec.cache_rows or shrink the batch")
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


def occurrence_csr(inv, width: int) -> tuple[np.ndarray, np.ndarray]:
    """The occurrence CSR of a plan inverse (host numpy): ``order`` lists
    the flat indices of the valid occurrences (0 <= inv < width) grouped by
    unique position, each group in occurrence order (a stable argsort);
    ``offsets`` (width + 1,) bounds each position's group. Both int32."""
    flat = np.asarray(inv).reshape(-1)
    occ = np.flatnonzero((flat >= 0) & (flat < width))
    keys = flat[occ]
    order = occ[np.argsort(keys, kind="stable")].astype(np.int32)
    offsets = np.zeros(width + 1, np.int32)
    np.cumsum(np.bincount(keys, minlength=width), out=offsets[1:])
    return order, offsets


def csr_segment_sum(order: torch.Tensor, offsets: torch.Tensor,
                    grads: torch.Tensor, width: int) -> torch.Tensor:
    """(n, D) occurrence gradients -> (width, D) fp32: row j sums
    ``grads[order[k]]`` for k in [offsets[j], offsets[j + 1]) in k order
    from 0.0 — the first pass of the ``fused_backward`` kernel, launched
    with nothing to apply (its plain version on the CPU)."""
    D = int(grads.shape[-1])
    g = grads.reshape(-1, D).float().contiguous()
    i32 = dict(dtype=torch.int32, device=g.device)
    return K.fused_backward(
        g.new_zeros((0, D)), None, order.to(torch.int32),
        offsets.to(torch.int32), g, torch.full((int(width),), -1, **i32),
        None, lr=0.0, eps=0.0, apply_self=True)


def plan_segment_sum(inv: torch.Tensor, grads: torch.Tensor, width: int
                     ) -> torch.Tensor:
    """Occurrence-width gradients -> (width, D) fp32 unique-width sums.

    Sums run in occurrence order from 0.0 — the order of the JAX package's
    scatter-add — so they are bit-identical to it. Invalid occurrences
    (inv < 0) contribute nothing. The CSR is built on the host."""
    order, offsets = occurrence_csr(inv.cpu().numpy(), width)
    return csr_segment_sum(torch.from_numpy(order).to(grads.device),
                           torch.from_numpy(offsets).to(grads.device),
                           grads.reshape(inv.numel(), -1), width)


def pad_axis0(arr: torch.Tensor, width: int, fill) -> torch.Tensor:
    """Pad (n, ...) to (width, ...) along axis 0 with ``fill`` (n <= width)
    — fitting a plan-bucket-width put into the fixed-width staleness
    queue."""
    n = int(arr.shape[0])
    if n == width:
        return arr
    out = torch.full((width,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                     device=arr.device)
    out[:n] = arr
    return out


# ---------------------------------------------------------------------------
# Checkpoint migration: full-width queue blobs -> unique width (numpy, copied)
# ---------------------------------------------------------------------------

def migrate_queue_blob(q, new_width: int):
    """Re-encode one staleness-queue blob at ``new_width`` by deduplicating
    each of its tau pending puts (numpy, host-side — the restore path).

    Accepts the dense form ({ids, grads, ptr, filled}) and the host-LRU
    form (+ slots; dedup keys on the slot, the id rides along). Summation
    runs in occurrence order per key, so a migrated queue's pops apply the
    exact same fp32 updates the full-width queue would have."""
    ids = np.asarray(q["ids"])
    grads = np.asarray(q["grads"])
    slots = np.asarray(q["slots"]) if "slots" in q else None
    tau, width = ids.shape
    new_width = int(new_width)
    key = slots if slots is not None else ids
    new_ids = np.full((tau, new_width), -1, ids.dtype)
    new_grads = np.zeros((tau, new_width, grads.shape[-1]), grads.dtype)
    new_slots = (None if slots is None
                 else np.full((tau, new_width), -1, slots.dtype))
    for t in range(tau):
        k = key[t]
        valid = k >= 0
        uniq, first, inv = np.unique(k[valid], return_index=True,
                                     return_inverse=True)
        if uniq.size > new_width:
            raise ValueError(
                f"queue slot {t} holds {uniq.size} unique puts but the "
                f"migrated width is only {new_width} — the dedup capacity "
                "rule should make this impossible; was the blob edited?")
        acc = np.zeros((uniq.size, grads.shape[-1]), np.float32)
        np.add.at(acc, inv, grads[t][valid].astype(np.float32))
        new_grads[t, : uniq.size] = acc.astype(grads.dtype)
        if slots is None:
            new_ids[t, : uniq.size] = uniq
        else:
            new_slots[t, : uniq.size] = uniq
            new_ids[t, : uniq.size] = ids[t][valid][first]
    out = {"ids": new_ids, "grads": new_grads,
           "ptr": np.asarray(q["ptr"]), "filled": np.asarray(q["filled"])}
    if new_slots is not None:
        out["slots"] = new_slots
    return out
