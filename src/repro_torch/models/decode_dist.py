"""Distributed single-token decode attention over sequence-sharded caches
(port of ``repro/models/decode_dist.py``), forward only.

Decode caches are (B, S, H_kv, D) with H_kv (often 8) smaller than the
``model`` mesh axis, so head-sharding cannot absorb the cache. The
*sequence* dimension is sharded over ``model`` instead (the PS idea
applied to the KV cache): each model rank owns a contiguous span of
positions, the new token is written by its owning rank only, and
attention is a local pass plus a logsumexp combine over ``model``
(``pmax`` of the maxima, then two sums: the corrected weights and the
corrected weighted values). Per step the collective traffic is
O(B * H * D), independent of S.

Each rank passes its blocks: its block of the batch (sharded over the
batch axes, replicated over ``model``) and its (B_local, S / n, ...) span
of the cache, with the (B_local,) lengths. The owning rank writes the new
token into its span IN PLACE (the other ranks rewrite the value a slot
already holds, so no second copy of the cache is made), and ``len`` grows
by one on every rank. Used when the mesh in scope has a ``model`` axis
and the cache is full-length (ring caches stay replicated).
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils import _mesh_axis_names, flat_index, pmax, psum

NEG_INF = -1e30


def have_model_axis() -> bool:
    return "model" in _mesh_axis_names()


def _local_update(c: torch.Tensor, slot_local: torch.Tensor,
                  new: torch.Tensor, in_range: torch.Tensor):
    """Write ``new`` (B, ...) at each row's slot of the (B, S_loc, ...)
    cache span where this rank owns the position, in place: every row
    writes one slot, the value it holds where the rank does not own it."""
    rows = torch.arange(c.shape[0], device=c.device)
    cur = c[rows, slot_local]
    ok = in_range.view(-1, *([1] * (cur.dim() - 1)))
    c[rows, slot_local] = torch.where(ok, new.to(c.dtype), cur)


def _span(cache_len: torch.Tensor, S_loc: int):
    """(this rank's index, its in-range mask, the local slot) of the new
    token at position ``len``."""
    me = flat_index(("model",))
    slot = cache_len.long()
    in_range = slot // S_loc == me
    return me, in_range, (slot - me * S_loc).clamp(0, S_loc - 1)


def _combine(s: torch.Tensor, vals: torch.Tensor, eq: str):
    """The logsumexp combine of masked local scores ``s`` (..., S_loc)
    with ``vals`` over ``model``: ``sum softmax(s) vals`` over every
    rank's positions."""
    m = torch.amax(s, dim=-1)
    p_ = torch.exp(s - m[..., None])
    l_ = torch.sum(p_, dim=-1)
    acc = torch.einsum(eq, p_, vals.float())
    m_g = pmax(m.clone(), ("model",))
    corr = torch.exp(m - m_g)
    l_g = psum((l_ * corr).contiguous(), ("model",))
    acc_g = psum((acc * corr[..., None]).contiguous(), ("model",))
    return acc_g / torch.clamp(l_g, min=1e-30)[..., None]


def gqa_decode_dist(p, cfg, q, k_new, v_new, cache, *, scale, softcap=0.0):
    """q: (B, 1, Hkv, G, Dh); k_new / v_new: (B, 1, Hkv, Dh); cache k / v:
    this rank's (B, S_loc, Hkv, Dh) span, updated in place. Returns (out
    (B, 1, Hkv, G, Dh), cache)."""
    S_loc = cache["k"].shape[1]
    me, in_range, slot_local = _span(cache["len"], S_loc)
    _local_update(cache["k"], slot_local, k_new[:, 0], in_range)
    _local_update(cache["v"], slot_local, v_new[:, 0], in_range)
    cache["len"] += 1
    kc, vc = cache["k"], cache["v"]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), kc.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    kpos = me * S_loc + torch.arange(S_loc, device=q.device)
    msk = kpos[None, :] < cache["len"][:, None]
    s = torch.where(msk[:, None, None, None, :], s, NEG_INF)
    out = _combine(s, vc, "bhgqk,bkhd->bhgqd")
    return out.permute(0, 3, 1, 2, 4).to(q.dtype), cache


def mla_decode_dist(cfg, q_abs, q_rope, ckv_new, kr_new, cache):
    """Weight-absorbed MLA decode over a sequence-sharded latent cache.

    q_abs: (B, 1, H, r) fp32; q_rope: (B, 1, H, dr); ckv_new: (B, 1, r);
    kr_new: (B, 1, dr); cache: this rank's span {'ckv': (B, S_loc, r),
    'k_rope': (B, S_loc, dr), 'len': (B,)}, updated in place. Returns
    (ctx (B, 1, H, r) fp32, cache)."""
    S_loc = cache["ckv"].shape[1]
    scale = 1.0 / math.sqrt(cfg.head_dim + cfg.rope_head_dim)
    me, in_range, slot_local = _span(cache["len"], S_loc)
    _local_update(cache["ckv"], slot_local, ckv_new[:, 0], in_range)
    _local_update(cache["k_rope"], slot_local, kr_new[:, 0], in_range)
    cache["len"] += 1
    ckv, krc = cache["ckv"], cache["k_rope"]
    s = (torch.einsum("bqhr,bkr->bhqk", q_abs, ckv.float())
         + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), krc.float())
         ) * scale
    kpos = me * S_loc + torch.arange(S_loc, device=q_abs.device)
    msk = kpos[None, :] < cache["len"][:, None]
    s = torch.where(msk[:, None, None, :], s, NEG_INF)
    ctx = _combine(s, ckv, "bhqk,bkr->bhqr")
    return ctx.permute(0, 2, 1, 3), cache
