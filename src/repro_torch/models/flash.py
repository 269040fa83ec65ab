"""Flash attention over the grouped-GQA layout (port of
``repro/models/flash.py::flash_attention``), forward and backward.

The models keep q as (B, Sq, Hkv, G, Dh), k as (B, Sk, Hkv, Dh) and v as
(B, Sk, Hkv, Dv); the ``flash_attention_fwd`` kernel takes (B, Hq, S, D*)
with query head ``h = hkv * G + g``. The value head Dv may be narrower
than the query/key head (MLA's 128 beside 192), forward and backward.
This module converts between the two (contiguous copies) and calls
``kernels.ops.flash_attention_fwd``: the CUDA kernel on the card, its
plain version on the CPU. No padding: the kernel masks its ragged tiles
itself.

With grad enabled the call goes through :class:`FlashAttention`, whose
forward is that same call, saving q, k, v, o and the rows' logsumexp, and
whose backward is the JAX package's jnp ``_bwd`` in plain torch
(:func:`flash_attention_bwd`): ``Drow = rowsum(dO * O)``, then a dq pass
over q blocks and a dk/dv pass over kv blocks, each rebuilding its
probability tiles from q, k and the saved logsumexp, so memory stays
linear in S. ``src/repro/kernels/`` has no backward kernel; a hand-written
one is optional later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref

# the backward's tile: (B, Hkv, G, Q_BLOCK, K_BLOCK) fp32 scores at a time
Q_BLOCK, K_BLOCK = 256, 512


def to_kernel_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(B, Sq, Hkv, G, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dv) -> (B, Hkv *
    G, Sq, Dh), (B, Hkv, Sk, Dh), (B, Hkv, Sk, Dv), contiguous."""
    B, Sq, Hkv, G, Dh = q.shape
    qk = q.permute(0, 2, 3, 1, 4).reshape(B, Hkv * G, Sq, Dh).contiguous()
    return (qk, k.permute(0, 2, 1, 3).contiguous(),
            v.permute(0, 2, 1, 3).contiguous())


def from_kernel_layout(o: torch.Tensor, q_shape) -> torch.Tensor:
    """(B, Hkv * G, Sq, Dv) -> (B, Sq, Hkv, G, Dv)."""
    B, Sq, Hkv, G, _ = q_shape
    return o.reshape(B, Hkv, G, Sq, -1).permute(0, 3, 1, 2, 4)


def _tile_masked(qs, qe, ks, ke, causal, window, q_offset) -> bool:
    """Whether every (query, key) pair of the tile is masked: its keys all
    lie after its last query (causal), or before its first query's window.
    Such a tile's probabilities are exactly 0 and it adds nothing."""
    if causal and ks > qe - 1 + q_offset:
        return True
    return window > 0 and qs + q_offset - (ke - 1) >= window


def flash_attention_bwd(q, k, v, o, lse, do, scale: float,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """The gradients (dq, dk, dv) of ``flash_attention_fwd`` in the kernel
    layout: q (B, Hq, Sq, Dh); o, do (B, Hq, Sq, Dv); k (B, Hkv, Sk, Dh);
    v (B, Hkv, Sk, Dv); lse (B, Hq, Sq) fp32. ``Drow`` and ``dP = dO V^T``
    contract over Dv; dv is (..., Dv), dq and dk (..., Dh). fp32
    arithmetic; the gradients come back in the inputs' dtypes. The masks
    are the forward's (causal, window, the ragged last block); tiles that
    are wholly masked are skipped. A tile is ``Q_BLOCK`` x ``K_BLOCK``."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G, Dv = Hq // Hkv, v.shape[-1]
    qf = q.float().reshape(B, Hkv, G, Sq, Dh)
    dof = do.float().reshape(B, Hkv, G, Sq, Dv)
    kf, vf = k.float(), v.float()
    lsef = lse.float().reshape(B, Hkv, G, Sq, 1)
    drow = torch.sum(dof * o.float().reshape(B, Hkv, G, Sq, Dv), dim=-1,
                     keepdim=True)                       # (B,Hkv,G,Sq,1)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    qb = [(s, min(s + Q_BLOCK, Sq)) for s in range(0, Sq, Q_BLOCK)]
    kb = [(s, min(s + K_BLOCK, Sk)) for s in range(0, Sk, K_BLOCK)]

    def tile(qs, qe, ks, ke):
        """(p, ds) of one (q block, kv block) tile, rebuilt from lse."""
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf[:, :, :, qs:qe],
                         kf[:, :, ks:ke]) * scale
        mask = torch.ones((qe - qs, ke - ks), dtype=torch.bool,
                          device=q.device)
        qp, kp = qpos[qs:qe, None], kpos[None, ks:ke]
        if causal:
            mask &= qp >= kp
        if window > 0:
            mask &= qp - kp < window
        s = torch.where(mask, s, ref.NEG_INF)
        p = torch.exp(s - lsef[:, :, :, qs:qe])
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dof[:, :, :, qs:qe],
                          vf[:, :, ks:ke])
        return p, p * (dp - drow[:, :, :, qs:qe])

    dq = torch.zeros_like(qf)
    for qs, qe in qb:                                    # the dq pass
        for ks, ke in kb:
            if _tile_masked(qs, qe, ks, ke, causal, window, q_offset):
                continue
            _, ds = tile(qs, qe, ks, ke)
            dq[:, :, :, qs:qe] += torch.einsum(
                "bhgqk,bhkd->bhgqd", ds, kf[:, :, ks:ke]) * scale
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for ks, ke in kb:                                    # the dk/dv pass
        for qs, qe in qb:
            if _tile_masked(qs, qe, ks, ke, causal, window, q_offset):
                continue
            p, ds = tile(qs, qe, ks, ke)
            dv[:, :, ks:ke] += torch.einsum(
                "bhgqk,bhgqd->bhkd", p, dof[:, :, :, qs:qe])
            dk[:, :, ks:ke] += torch.einsum(
                "bhgqk,bhgqd->bhkd", ds, qf[:, :, :, qs:qe]) * scale
    return (dq.reshape(B, Hq, Sq, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """``ops.flash_attention_fwd`` (the kernel on the card) with the
    recompute-from-logsumexp backward of :func:`flash_attention_bwd`; kernel
    layout in and out."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, q_offset):
        o, lse = ops.flash_attention_fwd(q, k, v, scale, causal, window,
                                         q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, Hkv, G, Dh); k: (B, Sk, Hkv, Dh); v: (B, Sk, Hkv, Dv) ->
    (B, Sq, Hkv, G, Dv) in q's dtype. Differentiable (through
    :class:`FlashAttention`) when grad is enabled and an input requires
    it; otherwise the bare forward call, as serving makes it."""
    args = (*to_kernel_layout(q, k, v), scale, causal, window, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o = FlashAttention.apply(*args)
    else:
        o, _ = ops.flash_attention_fwd(*args)
    return from_kernel_layout(o, q.shape)
