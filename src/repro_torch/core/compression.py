"""Persia §4.2.3 communication compression (port of
``repro/core/compression.py``).

* Lossy value compression: fp32 -> fp16 block scaling. Each block ``v`` is
  scaled by ``KAPPA / ||v||_inf`` before the fp16 cast and unscaled after,
  so the fp16 mantissa covers the block's own dynamic range. The functions
  here are the plain torch codec (any ``block``); the wire runs the CUDA
  kernels through ``kernels.ops.blockscale_*``.
* Lossless index compression: a batch of multi-hot samples re-encoded as a
  unique-id keyed map with uint16 sample indices (host numpy, copied).
* Put aggregation: duplicate ids in a gradient put are summed to one row
  per unique id (:func:`dedup_put`). On the device the grouping is a stable
  sort and the sums run through the ``fused_backward`` kernel's segment sum
  along the groups' CSR, in occurrence order: the order of the JAX
  package's scatter-add, and deterministic, unlike ``index_add_``, whose
  atomics add in an order that changes from run to run.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dedup import DedupPlan, csr_segment_sum
from repro_torch.kernels import ref as KR
from repro_torch.kernels.ref import KAPPA  # noqa: F401 (the paper's kappa)

_INT64_MAX = torch.iinfo(torch.int64).max


# ---------------------------------------------------------------------------
# Lossy blockscale fp16 (the plain torch codec)
# ---------------------------------------------------------------------------

def blockscale_compress(v: torch.Tensor, block: int = 128):
    """v: (..., D) fp32 -> (fp16 blocks (n_blocks, block), fp32 per-block
    scales (n_blocks,), v's shape); the flat tail is zero-padded to a whole
    block."""
    comp, scale = KR.blockscale_compress_ref(v, block)
    return comp, scale, tuple(v.shape)


def blockscale_decompress(comp: torch.Tensor, scale: torch.Tensor,
                          orig_shape) -> torch.Tensor:
    n = 1
    for s in orig_shape:
        n *= int(s)
    blocks = KR.blockscale_decompress_ref(comp, scale)
    return blocks.reshape(-1)[:n].reshape(tuple(orig_shape))


def blockscale_roundtrip(v: torch.Tensor, block: int = 128) -> torch.Tensor:
    return blockscale_decompress(*blockscale_compress(v, block))


# ---------------------------------------------------------------------------
# Lossless index compression (wire format, host-side numpy, copied)
# ---------------------------------------------------------------------------

def compress_index_batch(ids_batch: np.ndarray):
    """ids_batch: (B, L) int64 multi-hot sample ids (-1 = padding).

    Returns (unique_ids int64 (U,), offsets uint32 (U+1,), sample_idx
    uint16) — the paper's hash-map representation: for each unique id, the
    list of samples containing it, with indices stored as uint16 (B <=
    65535)."""
    B, L = ids_batch.shape
    if B > 65535:
        raise ValueError(
            f"compress_index_batch stores sample indices as uint16, so the "
            f"batch size must be <= 65535 (got {B}); split the batch before "
            "encoding")
    samples = np.repeat(np.arange(B, dtype=np.uint16), L)
    flat = ids_batch.reshape(-1)
    keep = flat >= 0
    flat, samples = flat[keep], samples[keep]
    order = np.argsort(flat, kind="stable")
    flat, samples = flat[order], samples[order]
    unique, starts = np.unique(flat, return_index=True)
    offsets = np.concatenate([starts, [flat.size]]).astype(np.uint32)
    return unique.astype(np.int64), offsets, samples


def decompress_index_batch(unique, offsets, samples, batch, width):
    """Inverse of compress_index_batch (padding with -1)."""
    out = np.full((batch, width), -1, dtype=np.int64)
    fill = np.zeros(batch, dtype=np.int64)
    for u, s, e in zip(unique, offsets[:-1], offsets[1:]):
        for smp in samples[s:e]:
            out[smp, fill[smp]] = u
            fill[smp] += 1
    return out


def index_compression_ratio(ids_batch: np.ndarray) -> float:
    """bytes(original int64 list-of-vectors) / bytes(compressed map)."""
    raw = ids_batch.size * 8
    u, off, smp = compress_index_batch(ids_batch)
    comp = u.size * 8 + off.size * 4 + smp.size * 2
    return raw / max(comp, 1)


# ---------------------------------------------------------------------------
# Put aggregation on the device
# ---------------------------------------------------------------------------

def dedup_plan(ids: torch.Tensor, capacity: int) -> DedupPlan:
    """The grouping of :func:`dedup_put` as a :class:`~repro_torch.core.
    dedup.DedupPlan`, built on the ids' device without a host sync:

    * ``dev`` (capacity,) int32: the distinct ids (>= 0) in ascending order,
      -1 in unused slots; past ``capacity`` distinct ids the largest are
      dropped (the paper tolerates an infrequent lost put);
    * ``inv`` (T,) int32: each entry's slot, -1 for padding and dropped
      entries;
    * ``order``/``offsets``: the CSR of ``inv``, each group in occurrence
      order (a stable sort), what ``fused_backward`` sums along.
    """
    flat = ids.reshape(-1).long()
    T, capacity = int(flat.numel()), int(capacity)
    dev = flat.device
    key, order = torch.sort(torch.where(flat < 0, _INT64_MAX, flat),
                            stable=True)
    valid = key != _INT64_MAX
    new = torch.ones_like(valid)
    new[1:] = key[1:] != key[:-1]
    group = torch.cumsum((new & valid).long(), 0) - 1
    group = torch.where(valid, group, capacity)          # non-decreasing
    offsets = torch.searchsorted(
        group, torch.arange(capacity + 1, device=dev), side="left")
    count = offsets[1:] - offsets[:-1]
    first = key[offsets[:-1].clamp(max=max(T - 1, 0))] if T else \
        torch.zeros(capacity, dtype=torch.long, device=dev)
    uniq = torch.where(count > 0, first, -1)
    kept = torch.where(group < capacity, group, -1)
    inv = torch.empty(T, dtype=torch.long, device=dev)
    inv[order] = kept
    return DedupPlan(dev=uniq.to(torch.int32), inv=inv.to(torch.int32),
                     order=order.to(torch.int32),
                     offsets=offsets.to(torch.int32))


def dedup_put(ids: torch.Tensor, grads: torch.Tensor, capacity: int):
    """Aggregate duplicate ids in a gradient put.

    ids: (T,) int (-1 = padding); grads: (T, D). Returns (unique_ids
    (capacity,) int32 ascending, summed_grads (capacity, D) fp32); unused
    slots carry id -1 and zero sums; past ``capacity`` distinct ids the
    largest are dropped."""
    plan = dedup_plan(ids, capacity)
    return plan.dev, csr_segment_sum(plan.order, plan.offsets, grads,
                                     capacity)
