"""Plain torch versions of the port's kernels (the counterpart of
``repro/kernels/ref.py``). The CPU tests run them, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.

The bag pools add the L rows one ``l`` at a time, in order, starting from
zero, and skip padding with a select: the same additions in the same order
as the CUDA kernels and as the Pallas kernels in interpret mode, so all
three agree bit for bit.
"""
from __future__ import annotations

import torch


def _pool_in_order(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """rows (B, L, D), valid (B, L) -> (B, D): sum over l in order."""
    B, L, D = rows.shape
    out = torch.zeros((B, D), dtype=rows.dtype, device=rows.device)
    for l in range(L):
        out = torch.where(valid[:, l, None], out + rows[:, l], out)
    return out


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (V, D); ids (B, L), < 0 (or >= V) = padding -> (B, D) sum."""
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = table[torch.where(valid, ids, 0).long()]
    return _pool_in_order(rows, valid)


def unique_bag_ref(table: torch.Tensor, dev: torch.Tensor,
                   inv: torch.Tensor) -> torch.Tensor:
    """table (V, D); dev (U,) table rows, < 0 = padding; inv (B, L)
    positions in ``dev``, < 0 = padding -> (B, D) sum of
    ``table[dev[inv]]``: the dedup-plan lookup (unique gather, inverse
    scatter, bag pool) as one function."""
    U = dev.shape[0]
    valid = (inv >= 0) & (inv < U)
    if U:
        row_ids = dev[torch.where(valid, inv, 0).long()]
        valid = valid & (row_ids >= 0) & (row_ids < table.shape[0])
    else:
        row_ids = torch.zeros_like(inv)
    rows = table[torch.where(valid, row_ids, 0).long()]
    return _pool_in_order(rows, valid)
