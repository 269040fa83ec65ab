"""Plain torch versions of the port's kernels (the counterpart of
``repro/kernels/ref.py``). The CPU tests run them, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.

The bag pools add the L rows one ``l`` at a time, in order, starting from
zero, and skip padding with a select: the same additions in the same order
as the CUDA kernels and as the Pallas kernels in interpret mode, so all
three agree bit for bit. ``fused_backward_ref`` repeats its CUDA kernel's
operations in the kernel's order (see its section below), and the
blockscale codec's operations are each one correctly rounded IEEE
operation, in the kernel and here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

KAPPA = 32_768.0    # the paper's "relatively large constant scalar"


# ---------------------------------------------------------------------------
# blockscale: the §4.2.3 lossy fp32 -> fp16 wire codec
# ---------------------------------------------------------------------------

def blockscale_compress_ref(v: torch.Tensor, block: int = 128):
    """Any-shape fp32 ``v``, flattened and zero-padded to whole blocks of
    ``block`` -> ``(comp, scales)``: ``comp`` (n_blocks, block) fp16 =
    ``fp16(v * s)`` rounded to nearest even, ``scales`` (n_blocks,) fp32 =
    ``KAPPA / max(max|v|, 1e-30)`` per block (NaN in a block gives a NaN
    scale)."""
    flat = v.reshape(-1).float()
    blocks = F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)
    linf = blocks.abs().amax(dim=1)
    scale = torch.full_like(linf, KAPPA) / torch.clamp(linf, min=1e-30)
    return (blocks * scale[:, None]).to(torch.float16), scale


def blockscale_decompress_ref(comp: torch.Tensor, scales: torch.Tensor
                              ) -> torch.Tensor:
    """(n_blocks, block) fp16 and (n_blocks,) fp32 scales -> (n_blocks,
    block) fp32 ``comp / s``: a true division, never a multiply by 1/s."""
    return comp.float() / scales[:, None]


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


# ---------------------------------------------------------------------------
# fused_backward: segment-sum + row-wise adagrad/sgd apply + queue payload
# ---------------------------------------------------------------------------
#
# The plain version does every float operation of the CUDA kernel
# (csrc/fused_backward.cu), one correctly rounded operation at a time and in
# the same order, so on the card the two agree bit for bit:
# * a segment adds its occurrence rows in occurrence order, from 0.0;
# * mean(g^2) adds the squares in column order, then divides by D;
# * the adagrad scale is 1 / sqrt(acc + eps) (two rounded operations; the
#   square root is taken in float64 and rounded once to float32, which is
#   the correctly rounded float32 root: torch's float32 sqrt on the CPU is
#   not correctly rounded everywhere, __fsqrt_rn is);
# * rows that several apply positions share take their updates in position
#   order: every increment reaches acc before any scale is read, and the
#   row adds the positions' updates one after another.


def segment_sum_ref(order: torch.Tensor, offsets: torch.Tensor,
                    grads: torch.Tensor, cap: int) -> torch.Tensor:
    """(cap, D) fp32. Row j < len(offsets) - 1 sums ``grads[order[k]]`` for
    k in [offsets[j], offsets[j + 1]) in k order from 0.0 (k clipped to
    ``order``; entries of ``order`` outside the rows of ``grads`` are
    skipped); the other rows are zero."""
    n_occ, D = grads.shape
    out = torch.zeros((cap, D), dtype=torch.float32, device=grads.device)
    n_seg, n_ord = min(offsets.numel() - 1, cap), order.numel()
    if n_seg <= 0 or n_ord == 0:
        return out
    lo = offsets[:n_seg].long().clamp(0, n_ord)
    cnt = (offsets[1:n_seg + 1].long().clamp(0, n_ord) - lo).clamp(min=0)
    active = torch.nonzero(cnt > 0).flatten()
    k = 0
    while active.numel():
        src = order[lo[active] + k].long()
        ok = (src >= 0) & (src < n_occ)
        rows = grads[src.clamp(0, max(n_occ - 1, 0))].float()
        cur = out[active]
        out[active] = torch.where(ok[:, None], cur + rows, cur)
        k += 1
        active = active[cnt[active] > k]
    return out


def _rank_passes(rows: torch.Tensor) -> list[torch.Tensor]:
    """Positions of ``rows`` split into passes: pass p holds the p-th
    position (in position order) of every distinct row, so the rows within
    one pass are distinct and an indexed add per pass is deterministic."""
    n = rows.numel()
    srt, perm = torch.sort(rows, stable=True)
    new = torch.ones(n, dtype=torch.bool, device=rows.device)
    new[1:] = srt[1:] != srt[:-1]
    pos = torch.arange(n, device=rows.device)
    start = torch.cummax(torch.where(new, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[perm] = pos - start
    return [torch.nonzero(rank == p).flatten()
            for p in range(int(rank.max()) + 1)]


def _mean_sq(x: torch.Tensor) -> torch.Tensor:
    """(n, D) -> (n,) mean of squares, the squares added in column order."""
    s = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for d in range(x.shape[1]):
        s = s + x[:, d] * x[:, d]
    return s / torch.full_like(s, x.shape[1])


def apply_rows_ref(table: torch.Tensor, acc, idx: torch.Tensor,
                   g: torch.Tensor, *, lr: float, eps: float) -> None:
    """Row-wise adagrad (``acc`` given) or sgd (``acc=None``) step of
    ``g[j]`` on ``table[idx[j]]``, in place; ``idx`` outside [0, R) is a
    no-op. The JAX package's ``_apply_sparse`` arithmetic: duplicate rows
    accumulate (all increments reach acc before any scale is read)."""
    R = table.shape[0]
    js = torch.nonzero((idx >= 0) & (idx < R)).flatten()
    if js.numel() == 0:
        return
    rows = idx[js].long()
    step = g[js].float()
    passes = _rank_passes(rows)
    if acc is not None:
        inc = _mean_sq(step)
        for p in passes:
            acc[rows[p]] = acc[rows[p]] + inc[p]
        root = torch.sqrt((acc[rows] + eps).double()).float()
        step = step * torch.reciprocal(root)[:, None]
    upd = (step * -lr).to(table.dtype)
    for p in passes:
        table[rows[p]] = table[rows[p]] + upd[p]


def fused_backward_ref(table: torch.Tensor, acc, order: torch.Tensor,
                       offsets: torch.Tensor, grads: torch.Tensor,
                       apply_idx: torch.Tensor, apply_g, *, lr: float,
                       eps: float, apply_self: bool = False) -> torch.Tensor:
    """One-pass embedding backward (port of ``repro.kernels.ref.
    fused_backward_ref``), in place.

    table (R, D) and acc (R,) (``None``: sgd) are updated in place; order
    and offsets are the dedup plan's occurrence CSR (``order`` lists the
    valid occurrences, grouped by unique position in occurrence order;
    ``offsets`` (U + 1,) bounds each position's run); grads (n_occ, D) are
    the occurrence gradients; apply_idx (cap,) are the table rows to update
    (-1 = no-op) with apply_g (cap, D) their gradients, or, with
    ``apply_self``, this call's own segment sums (sync / staleness 0).

    Returns g_push (cap, D) fp32: the segment sums, zero past U — the
    queue-ready payload."""
    g_push = segment_sum_ref(order, offsets, grads, apply_idx.shape[0])
    apply_rows_ref(table, acc, apply_idx, g_push if apply_self else apply_g,
                   lr=lr, eps=eps)
    return g_push
