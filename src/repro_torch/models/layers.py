"""Primitive layers of the LM family (port of ``repro/models/layers.py``):
inits, norms, RoPE, attention, the GQA (self- and cross-attention) and MLA
attention blocks and the MLPs, as plain functions over parameter dicts in
the JAX package's layout and key names, so weights carry across unchanged
(``repro_torch.convert``).

Inits draw from an explicit ``torch.Generator``; ``lead`` puts a leading
stack axis in front of every weight (the transformer's stacked layers),
drawn in one call and scaled in place (a stacked expert leaf of
DeepSeek-V2-Lite is 19.2 GB in fp32: no second copy). Norms and RoPE run
in fp32, as in JAX. The JAX package's sharding hints (``utils.shard``) do
nothing on one card and are dropped.

Attention. Every uncapped full-sequence attention (training, prefill,
the cross-attention over a memory at Sq != Sk, the encoder's non-causal
self-attention) goes through the ``flash_attention_fwd`` CUDA kernel on
the card, whatever its length; the JAX package takes ``_attn_naive`` up
to 2,048 positions, the same function (``kernels/ref.py`` is its
arithmetic). Training differentiates it through ``flash.FlashAttention``
(the JAX package's flash backward). Logit soft-capping
(``attn_logit_softcap > 0``) never reaches the kernel, as it never
reaches the Pallas kernel in JAX (which routes a capped call to jnp): a
capped full-sequence call is :func:`_attn_blockwise`, plain torch with
an online softmax over key blocks (memory linear in S), at every length
and on every device, differentiated by autograd as JAX differentiates
its scan. Decode attention stays plain torch, as the JAX package
computes it in jnp: the full-length cache's :func:`decode_attention`, a
sliding window's ring buffer (:func:`_decode_ring`) and the decode's
cross-attention over its cached memory K/V; MLA's decode is the JAX
package's weight-absorbed decode against the latent cache. Under a mesh
with a ``model`` axis, a full-length cache's decode and MLA's decode go
through ``decode_dist`` (sequence-sharded caches), as in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.models import flash
from repro_torch.models import tp as TP

NEG_INF = ref.NEG_INF


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None, *,
               lead: tuple = (), device=None) -> torch.Tensor:
    """(*lead, d_in, d_out) normal weights times ``scale`` (1/sqrt(d_in) by
    default), on ``device`` (the generator's by default)."""
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    device = generator.device if device is None else device
    w = torch.randn((*lead, d_in, d_out), generator=generator,
                    device=device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def embed_init(generator: torch.Generator, rows: int, dim: int,
               dtype=torch.float32, scale: float = 0.02, *, device=None
               ) -> torch.Tensor:
    device = generator.device if device is None else device
    w = torch.randn((rows, dim), generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def norm_init(cfg, d: int, *, lead: tuple = (), device=None) -> dict:
    p = {"w": torch.ones((*lead, d), dtype=torch.float32, device=device)}
    if cfg.norm != "rmsnorm":
        p["b"] = torch.zeros((*lead, d), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if "b" in p:
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    # a Python base: a tensor made from it on the card would be a blocking
    # host-to-device copy, once per layer and token
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (float(theta) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integer."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                        # (d/2,)
    ang = positions[..., None].float() * inv                    # (..., S, d/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention. Layout (grouped GQA): q (B, Sq, Hkv, G, Dh), k (B, Sk, Hkv, Dh),
# v (B, Sk, Hkv, Dv)
# ---------------------------------------------------------------------------

def _softcap(s: torch.Tensor, softcap: float) -> torch.Tensor:
    return torch.tanh(s / softcap) * softcap if softcap > 0 else s


def _attn_naive(q, k, v, *, scale, causal, window, q_offset, softcap=0.0):
    """The plain full-sequence attention: the JAX package's ``_attn_naive``,
    through the kernel layout of ``ref.flash_attention_fwd_ref`` (the same
    arithmetic); with ``softcap`` > 0 the scores are capped to ``softcap *
    tanh(s / softcap)`` before the mask, as in JAX."""
    if softcap > 0:
        s = _softcap(torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
                     * scale, softcap)
        qpos = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = torch.ones_like(s[0, 0, 0], dtype=torch.bool)
        if causal:
            mask &= qpos >= kpos
        if window > 0:
            mask &= qpos - kpos < window
        p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        return torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()).to(q.dtype)
    o, _ = ref.flash_attention_fwd_ref(
        *flash.to_kernel_layout(q, k, v), scale, causal, window, q_offset)
    return flash.from_kernel_layout(o, q.shape)


def _attn_blockwise(q, k, v, *, scale, causal, window, q_offset,
                    qblk=512, kblk=512, softcap=0.0):
    """The JAX package's ``_attn_blockwise`` in plain torch: per block of
    ``qblk`` queries an online softmax over blocks of ``kblk`` keys (a
    running max, its sum and the weighted values in fp32), so no score
    tensor larger than a tile lives at once. Ragged last blocks are sliced
    (JAX pads them; a padded key adds exactly 0), and a tile whose every
    (query, key) pair is masked is skipped: it would add exactly 0, or be
    wiped by the rescale of the first key its rows may attend. The result
    is JAX's within rounding; differentiable by autograd."""
    B, Sq, Hkv, G, _ = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    kf, vf = k.float(), v.float()
    kpos_all = torch.arange(Sk, device=q.device)
    outs = []
    for qs in range(0, Sq, qblk):
        qe = min(qs + qblk, Sq)
        qb = q[:, qs:qe].float()
        qpos = torch.arange(qs, qe, device=q.device)[:, None] + q_offset
        m = torch.full((B, Hkv, G, qe - qs), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, qe - qs), device=q.device)
        acc = torch.zeros((B, Hkv, G, qe - qs, Dv), device=q.device)
        for ks in range(0, Sk, kblk):
            ke = min(ks + kblk, Sk)
            if flash._tile_masked(qs, qe, ks, ke, causal, window, q_offset):
                continue
            s = _softcap(torch.einsum("bqhgd,bkhd->bhgqk", qb, kf[:, ks:ke])
                         * scale, softcap)
            kpos = kpos_all[None, ks:ke]
            msk = torch.ones((qe - qs, ke - ks), dtype=torch.bool,
                             device=q.device)
            if causal:
                msk = msk & (qpos >= kpos)
            if window > 0:
                msk = msk & (qpos - kpos < window)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, ks:ke])
            m = m_new
        ob = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(ob.permute(0, 3, 1, 2, 4))              # (B,q,Hkv,G,Dv)
    return torch.cat(outs, dim=1).to(q.dtype)


def grouped_attention(q, k, v, *, scale, causal=True, window=0, q_offset=0,
                      softcap=0.0):
    """Full-sequence attention, q (B, Sq, Hkv, G, Dh) over k (B, Sk, Hkv,
    Dh) and v (B, Sk, Hkv, Dv), Sq and Sk free: through
    ``flash.flash_attention`` (the CUDA kernel on the card, its plain
    version on the CPU) at every length; with grad enabled through its
    ``FlashAttention`` function, whose backward recomputes the tiles from
    the saved logsumexp. With ``softcap`` > 0, :func:`_attn_blockwise`
    (plain torch on every device: the kernel has no cap, as the Pallas
    kernel has none)."""
    if softcap > 0:
        return _attn_blockwise(q, k, v, scale=scale, causal=causal,
                               window=window, q_offset=q_offset,
                               softcap=softcap)
    return flash.flash_attention(q, k, v, scale=scale, causal=causal,
                                 window=window, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, cache_len, *, scale, window=0,
                     softcap=0.0):
    """Single-token decode. q: (B, 1, Hkv, G, Dh); caches: (B, S, Hkv, D*).

    ``cache_len`` (B,) is the number of valid entries (the new token already
    written at position cache_len - 1). Linear in S. The scores are capped
    as :func:`_attn_naive` caps them."""
    s = _softcap(torch.einsum("bqhgd,bkhd->bhgqk", q.float(),
                              k_cache.float()) * scale, softcap)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    msk = kpos[None, :] < cache_len[:, None]                      # (B, S)
    if window > 0:
        msk = msk & (cache_len[:, None] - 1 - kpos[None, :] < window)
    s = torch.where(msk[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def gqa_init(generator: torch.Generator, cfg, dtype=torch.float32, *,
             cross: bool = False, lead: tuple = (), device=None) -> dict:
    """Attention weights; with ``cross`` the key and value projections
    read the memory's width ``cfg.d_memory`` (cross-attention)."""
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dm = cfg.d_memory if cross else d
    kw = dict(lead=lead, device=device)
    p = {
        "wq": dense_init(generator, d, H * Dh, dtype, **kw),
        "wk": dense_init(generator, dm, Hkv * Dh, dtype, **kw),
        "wv": dense_init(generator, dm, Hkv * Dh, dtype, **kw),
        "wo": dense_init(generator, H * Dh, d, dtype,
                         scale=1.0 / math.sqrt(H * Dh), **kw),
    }
    if cfg.qk_norm:
        ones = dict(dtype=torch.float32, device=p["wq"].device)
        p["q_norm"] = {"w": torch.ones((*lead, Dh), **ones)}
        p["k_norm"] = {"w": torch.ones((*lead, Dh), **ones)}
    return p


def _project(p: dict, cfg, x: torch.Tensor, memory=None, *,
             every_head: bool = False):
    """The q, k, v projections of ``x`` (k and v of ``memory`` (B, M,
    d_memory) when given): ``(q (B, S, Hq, Dh), k, v (B, M, Hk, Dh), k0,
    h0)``, every head where the weights are whole. Under tensor
    parallelism q is the query heads from ``h0`` that this rank's column
    block of ``wq`` covers (its own heads; where the block ends inside a
    head, as 40 heads over 16 ranks do, the blocks are gathered over
    ``model`` and the rank keeps every head its block touches; with
    ``every_head`` all of them, as the decode needs), k and v the
    key/value heads from ``k0`` on: the rank's own column block where the
    n model ranks split the Hkv heads evenly, else every head (each rank's
    column block is part of a head: the blocks are gathered over
    ``model``; the rank keeps the heads it reads in
    :func:`_group_heads`). The per-head norms run on those heads."""
    B, S, _ = x.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    tp = TP.split(p["wq"], cfg.n_heads * Dh)
    n, r = (TP.n_model(), TP.model_index()) if tp else (1, 0)
    enter = TP.enter if tp else (lambda t: t)
    xe = enter(x)
    src = xe if memory is None else enter(memory)
    q = xe @ p["wq"]
    cols = q.shape[-1]
    h0 = r * cols // Dh
    if tp and every_head:
        q, h0 = TP.gather_model(q), 0
    elif cols % Dh:                       # the block ends inside a head
        h1 = -(-(r + 1) * cols // Dh)
        q = TP.gather_model(q)[..., h0 * Dh:h1 * Dh]
    q = q.reshape(B, S, -1, Dh)
    k, v = src @ p["wk"], src @ p["wv"]
    if Hkv % n == 0 and k.shape[-1] == Hkv // n * Dh:
        k0 = r * (Hkv // n)
    else:
        if k.shape[-1] != Hkv * Dh:
            k, v = TP.gather_model(k), TP.gather_model(v)
        k0 = 0
    k = k.reshape(B, src.shape[1], -1, Dh)
    v = v.reshape(B, src.shape[1], -1, Dh)
    if cfg.qk_norm:
        q = rmsnorm(q, enter(p["q_norm"]["w"]), cfg.norm_eps)
        k = rmsnorm(k, enter(p["k_norm"]["w"]), cfg.norm_eps)
    return q, k, v, k0, h0


def _group_heads(cfg, q, k, v, k0: int, h0: int):
    """The (B, S, Hq, Dh) query heads from ``h0`` over the key/value heads
    they read (from ``k``'s heads, the first of them head ``k0``): q
    grouped (B, S, Hkv_l, G_l, Dh), k and v (B, M, Hkv_l, Dh)."""
    B, S, Hq, Dh = q.shape
    G = cfg.n_heads // cfg.n_kv_heads
    lo, hi = h0 // G, (h0 + Hq - 1) // G + 1
    if Hq % (hi - lo) or (hi - lo > 1 and (h0 % G or Hq % G)):
        raise ValueError(f"query heads {h0}..{h0 + Hq - 1} do not group "
                         f"evenly over key/value heads of {G}")
    k, v = k[:, :, lo - k0:hi - k0], v[:, :, lo - k0:hi - k0]
    return q.reshape(B, S, hi - lo, Hq // (hi - lo), Dh), k, v


def _rank_cols(o: torch.Tensor, w: torch.Tensor, h0: int, Dh: int):
    """The attention output's (B, S, Hq * Dv) columns of query heads from
    ``h0`` cut to this rank's block of ``w``'s rows (the rank computed
    every head its block touches)."""
    rows = w.shape[0]
    if o.shape[-1] == rows:
        return o
    c0 = TP.model_index() * rows - h0 * Dh
    return o[..., c0:c0 + rows]


def _full_kv(cfg, k, k0: int):
    """Every key/value head of the rank's (B, M, Hk, Dh) heads from
    ``k0`` (the decode caches hold every head)."""
    return k if k.shape[2] == cfg.n_kv_heads else TP.gather_model(k, 2)


def _out_proj(w: torch.Tensor, o: torch.Tensor, full: int) -> torch.Tensor:
    """``o`` (..., H_l * Dv) through ``w``: under tensor parallelism ``w``
    is the rank's block of rows (of ``full``) and the products are summed
    over ``model``."""
    if TP.split(w, full, 0):
        return TP.leave(o @ w)
    return o @ w


def gqa_forward(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                window=None, use_rope=True, full_kv: bool = False):
    """Self-attention over the full sequence (training / prefill). Returns
    ``(out, (k, v))`` with k and v after RoPE, (B, S, Hkv, Dh): under
    tensor parallelism the heads this rank reads, every head with
    ``full_kv`` (a prefill's caches)."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    q, k, v, k0, h0 = _project(p, cfg, x)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kv = (_full_kv(cfg, k, k0), _full_kv(cfg, v, k0)) if full_kv else None
    q, k, v = _group_heads(cfg, q, k, v, k0, h0)
    w = cfg.sliding_window if window is None else window
    out = grouped_attention(q, k, v, scale=1.0 / math.sqrt(Dh),
                            causal=True, window=w,
                            softcap=cfg.attn_logit_softcap)
    out = _rank_cols(out.reshape(B, S, -1), p["wo"], h0, Dh)
    out = _out_proj(p["wo"], out, cfg.n_heads * Dh)
    return out, (kv or (k, v))


def cross_attn_forward(p: dict, cfg, x: torch.Tensor, memory: torch.Tensor,
                       *, causal: bool = False, full_kv: bool = False):
    """Cross-attention of the (B, S) queries to a fixed memory (B, M,
    d_memory) (image patches / encoder frames): non-causal, no RoPE, no
    window, no cap (as in JAX), Sq = S over Sk = M through
    :func:`grouped_attention` (the kernel on the card). Returns ``(out,
    (k, v))``, k and v (B, M, Hkv, Dh) for the decode's cache (every head
    with ``full_kv`` under tensor parallelism). With ``memory`` the
    queries' own sequence it is the encoder's self-attention."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    q, k, v, k0, h0 = _project(p, cfg, x, memory)
    kv = (_full_kv(cfg, k, k0), _full_kv(cfg, v, k0)) if full_kv else None
    q, k, v = _group_heads(cfg, q, k, v, k0, h0)
    out = grouped_attention(q, k, v, scale=1.0 / math.sqrt(Dh),
                            causal=causal, window=0)
    out = _rank_cols(out.reshape(B, S, -1), p["wo"], h0, Dh)
    out = _out_proj(p["wo"], out, cfg.n_heads * Dh)
    return out, (kv or (k, v))


def _decode_heads(p: dict, cfg, x: torch.Tensor):
    """The decode step's q (B, 1, Hkv, G, Dh) and new k, v (B, 1, Hkv, Dh)
    over every head: under tensor parallelism the rank's blocks gathered
    over ``model`` (the caches, and the sequence-sharded decode, need
    every head on every rank)."""
    q, k, v, k0, _ = _project(p, cfg, x, every_head=True)
    k, v = _full_kv(cfg, k, k0), _full_kv(cfg, v, k0)
    return q.reshape(*q.shape[:2], cfg.n_kv_heads, -1, cfg.head_dim), k, v


def decode_out(p: dict, cfg, o: torch.Tensor, dv: int) -> torch.Tensor:
    """A decode step's every-head output (B, 1, H * dv) through ``wo``:
    under tensor parallelism the rank's heads through its rows, summed
    over ``model``."""
    full = cfg.n_heads * dv
    if TP.split(p["wo"], full, 0):
        hl = p["wo"].shape[0]
        o = o[..., TP.model_index() * hl:][..., :hl]
    return _out_proj(p["wo"], o, full)


def gqa_decode(p: dict, cfg, x: torch.Tensor, cache: dict, *, window=None,
               use_rope=True):
    """One-token decode against a cache ``{'k': (B, S, Hkv, Dh), 'v': ...,
    'len': (B,)}``, updated IN PLACE: the new token's k and v are written
    at slot ``len`` (full attention; clamped to the last slot, as JAX's
    ``dynamic_update_slice`` clamps) or, with a sliding window, at slot
    ``len % S`` of the ring buffer (:func:`_decode_ring`; S is the cache's
    own length: a ring from :func:`gqa_cache_init`, or a prefill's
    full-length cache, which then never wraps), and ``len`` grows by one.
    The cache's contents then equal the new cache the JAX package returns.
    Under a mesh with a ``model`` axis a full-length cache is the rank's
    sequence span (``decode_dist.gqa_decode_dist``); under tensor
    parallelism the step's heads are gathered first and the output leaves
    through the rank's rows of ``wo``. Returns ``(out, cache)``."""
    from repro_torch.models import decode_dist as DD
    w = cfg.sliding_window if window is None else window
    B, Dh = x.shape[0], cfg.head_dim
    q, k, v = _decode_heads(p, cfg, x)
    pos = cache["len"][:, None]                                   # (B, 1)
    if use_rope:
        q = apply_rope(q.reshape(B, 1, -1, Dh), pos,
                       cfg.rope_theta).reshape(q.shape)
        k = apply_rope(k, pos, cfg.rope_theta)
    if w <= 0 and DD.have_model_axis():
        out, cache = DD.gqa_decode_dist(
            p, cfg, q, k, v, cache, scale=1.0 / math.sqrt(Dh),
            softcap=cfg.attn_logit_softcap)
        return decode_out(p, cfg, out.reshape(B, 1, -1), Dh), cache
    rows = torch.arange(B, device=x.device)
    S = cache["k"].shape[1]
    slot = cache["len"].long()
    slot = slot % S if w > 0 else slot.clamp(max=S - 1)
    cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    cache["len"] += 1
    if w > 0:
        out = _decode_ring(q, cache["k"], cache["v"], cache["len"], w, cfg)
    else:
        out = decode_attention(q, cache["k"], cache["v"], cache["len"],
                               scale=1.0 / math.sqrt(Dh),
                               softcap=cfg.attn_logit_softcap)
    return decode_out(p, cfg, out.reshape(B, 1, -1), Dh), cache


def _decode_ring(q, kc, vc, new_len, window: int, cfg):
    """Decode attention over a ring-buffer cache of ``ring`` >= 1 slots:
    slot s holds the absolute position p with p % ring == s in [new_len -
    ring, new_len); a slot attends when its position lies in the last
    ``window`` positions and is >= 0. Scores capped as
    :func:`decode_attention` caps them."""
    ring = kc.shape[1]
    slots = torch.arange(ring, device=q.device)
    cur = new_len[:, None].long()                                 # (B, 1)
    abs_pos = cur - 1 - torch.remainder(cur - 1 - slots[None, :], ring)
    valid = (abs_pos >= 0) & (abs_pos >= cur - window) & (abs_pos < cur)
    s = _softcap(torch.einsum("bqhgd,bkhd->bhgqk", q.float(), kc.float())
                 / math.sqrt(cfg.head_dim), cfg.attn_logit_softcap)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, vc.float()).to(q.dtype)


def gqa_cache_init(cfg, batch: int, max_len: int, dtype=torch.float32, *,
                   window=None, lead: tuple = (), device=None) -> dict:
    """Zero K/V of ``max_len`` slots, or with a sliding window a ring of
    ``min(max_len, window)`` slots (the JAX package's sizes)."""
    w = cfg.sliding_window if window is None else window
    ring = min(max_len, w) if w > 0 else max_len
    shape = (*lead, batch, ring, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((*lead, batch), dtype=torch.int32,
                               device=device)}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2) block
# ---------------------------------------------------------------------------

def mla_init(generator: torch.Generator, cfg, dtype=torch.float32, *,
             lead: tuple = (), device=None) -> dict:
    """The JAX package's MLA weights: a direct query projection ``wq``, or
    with ``q_lora_rank`` > 0 the low-rank ``wdq`` -> ``q_ln`` -> ``wuq``;
    the joint KV down-projection ``wdkv`` (latent + the shared rope key),
    ``kv_ln``, the up-projections ``wuk`` / ``wuv`` and ``wo``."""
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    kw = dict(lead=lead, device=device)
    p = {}
    if r_q > 0:
        p["wdq"] = dense_init(generator, d, r_q, dtype, **kw)
        p["wuq"] = dense_init(generator, r_q, H * (dn + dr), dtype, **kw)
    else:
        p["wq"] = dense_init(generator, d, H * (dn + dr), dtype, **kw)
    p["wdkv"] = dense_init(generator, d, r_kv + dr, dtype, **kw)
    p["wuk"] = dense_init(generator, r_kv, H * dn, dtype, **kw)
    p["wuv"] = dense_init(generator, r_kv, H * dv, dtype, **kw)
    p["wo"] = dense_init(generator, H * dv, d, dtype,
                         scale=1.0 / math.sqrt(H * dv), **kw)
    ones = dict(dtype=torch.float32, device=p["wo"].device)
    if r_q > 0:
        p["q_ln"] = {"w": torch.ones((*lead, r_q), **ones)}
    p["kv_ln"] = {"w": torch.ones((*lead, r_kv), **ones)}
    return p


def _mla_q(p: dict, cfg, x: torch.Tensor):
    """(q_nope (B, S, H, head_dim), q_rope (B, S, H, rope_head_dim)); under
    tensor parallelism the rank's heads (``wq`` / ``wuq`` column blocks;
    the q latent of ``wdq`` is replicated)."""
    B, S, _ = x.shape
    dn, dr = cfg.head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank > 0:
        cq = rmsnorm(x @ p["wdq"], p["q_ln"]["w"], cfg.norm_eps)
        q = (TP.enter(cq) @ p["wuq"]).reshape(B, S, -1, dn + dr)
    else:
        q = (TP.enter(x) @ p["wq"]).reshape(B, S, -1, dn + dr)
    return q[..., :dn], q[..., dn:]


def mla_forward(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Full-sequence MLA (training / prefill): every head attends with a
    query/key of head_dim + rope_head_dim (the rope key shared by the
    heads) and a value of v_head_dim, through :func:`grouped_attention`
    (the kernel on the card, Hkv = H, G = 1). Returns ``(out, cache)``,
    the latent cache ``{"ckv": (B, S, kv_lora_rank), "k_rope": (B, S,
    rope_head_dim), "len": (B,)}``. Under tensor parallelism the rank's
    heads (``wuk`` / ``wuv`` column blocks, ``wo`` rows) over the
    replicated latent (``wdkv`` is replicated over ``model``)."""
    B, S, _ = x.shape
    dn, dr, r = cfg.head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(p, cfg, x)
    H = q_nope.shape[2]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_full = x @ p["wdkv"]                                  # (B, S, r+dr)
    ckv = rmsnorm(ckv_full[..., :r], p["kv_ln"]["w"], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., None, r:], positions,
                        cfg.rope_theta)                       # (B, S, 1, dr)
    ckv_e, k_rope_e = TP.enter(ckv), TP.enter(k_rope)
    k_nope = (ckv_e @ p["wuk"]).reshape(B, S, H, dn)
    v = (ckv_e @ p["wuv"]).reshape(B, S, H, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)[:, :, :, None, :]    # Hkv = H, G = 1
    k = torch.cat([k_nope, k_rope_e.expand(B, S, H, dr)], -1)
    out = grouped_attention(q, k, v, scale=1.0 / math.sqrt(dn + dr),
                            causal=True)
    out = _out_proj(p["wo"], out.reshape(B, S, -1),
                    cfg.n_heads * cfg.v_head_dim)
    cache = {"ckv": ckv, "k_rope": k_rope[:, :, 0, :],
             "len": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    return out, cache


def mla_decode(p: dict, cfg, x: torch.Tensor, cache: dict):
    """Weight-absorbed single-token MLA decode against the latent cache
    ``{'ckv': (B, S, r), 'k_rope': (B, S, dr), 'len': (B,)}``, updated IN
    PLACE as :func:`gqa_decode` updates its cache (the new latent at slot
    ``len``, clamped to the last slot; ``len`` + 1). ``wuk`` is absorbed
    into the query and ``wuv`` applied after the context, so each head
    attends over r + dr numbers a position. Under a mesh with a ``model``
    axis the cache is the rank's sequence span
    (``decode_dist.mla_decode_dist``); under tensor parallelism the
    absorbed queries of every head are gathered over ``model`` first and
    the rank's heads leave through its rows of ``wo``. Returns ``(out,
    cache)``."""
    from repro_torch.models import decode_dist as DD
    B = x.shape[0]
    dn, dr, dv, r = (cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    q_nope, q_rope = _mla_q(p, cfg, x)                        # (B, 1, H, *)
    H = q_nope.shape[2]
    pos = cache["len"][:, None]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    ckv_full = x @ p["wdkv"]
    ckv_new = rmsnorm(ckv_full[..., :r], p["kv_ln"]["w"], cfg.norm_eps)
    kr_new = apply_rope(ckv_full[..., None, r:], pos, cfg.rope_theta)[:, :, 0]
    # absorb W_uk into q: q_abs[h, r] = sum_dn q_nope[h, dn] * wuk[r, h, dn]
    wuk = p["wuk"].reshape(r, H, dn)
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wuk.float())
    wuv = p["wuv"].reshape(r, H, dv)
    tp = H != cfg.n_heads
    if tp:
        q_abs, q_rope = TP.gather_model(q_abs, 2), TP.gather_model(q_rope, 2)

    def heads(ctx):                           # the rank's heads of the ctx
        return ctx[:, :, TP.model_index() * H:][:, :, :H] if tp else ctx

    if DD.have_model_axis():
        ctx, cache = DD.mla_decode_dist(cfg, q_abs, q_rope, ckv_new, kr_new,
                                        cache)
        out = torch.einsum("bqhr,rhd->bqhd", heads(ctx), wuv.float())
        return _out_proj(p["wo"], out.reshape(B, 1, H * dv).to(x.dtype),
                         cfg.n_heads * dv), cache
    ckv_c, kr_c = cache["ckv"], cache["k_rope"]
    rows = torch.arange(B, device=x.device)
    slot = cache["len"].long().clamp(max=ckv_c.shape[1] - 1)
    ckv_c[rows, slot] = ckv_new[:, 0].to(ckv_c.dtype)
    kr_c[rows, slot] = kr_new[:, 0].to(kr_c.dtype)
    cache["len"] += 1
    s = (torch.einsum("bqhr,bkr->bhqk", q_abs, ckv_c.float())
         + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), kr_c.float())
         ) / math.sqrt(dn + dr)
    kpos = torch.arange(ckv_c.shape[1], device=x.device)
    valid = kpos[None, :] < cache["len"][:, None]             # (B, S)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    pa = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqk,bkr->bqhr", pa, ckv_c.float())   # (B, 1, H, r)
    out = torch.einsum("bqhr,rhd->bqhd", heads(ctx), wuv.float())
    out = _out_proj(p["wo"], out.reshape(B, 1, H * dv).to(x.dtype),
                    cfg.n_heads * dv)
    return out, cache


def mla_cache_init(cfg, batch: int, max_len: int, dtype=torch.float32, *,
                   lead: tuple = (), device=None) -> dict:
    return {"ckv": torch.zeros((*lead, batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "k_rope": torch.zeros((*lead, batch, max_len,
                                   cfg.rope_head_dim), dtype=dtype,
                                  device=device),
            "len": torch.zeros((*lead, batch), dtype=torch.int32,
                               device=device)}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, cfg, d_ff=None, dtype=torch.float32,
             *, lead: tuple = (), device=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(lead=lead, device=device)
    p = {"wu": dense_init(generator, d, f, dtype, **kw),
         "wd": dense_init(generator, f, d, dtype,
                          scale=1.0 / math.sqrt(f), **kw)}
    if cfg.ffn_act == "swiglu":
        p["wg"] = dense_init(generator, d, f, dtype, **kw)
    return p


def mlp_forward(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """The dense FFN; under tensor parallelism the rank's ``wg`` / ``wu``
    columns and ``wd`` rows, summed over ``model``."""
    tp = TP.split(p["wd"], cfg.d_ff, 0)
    if tp:
        x = TP.enter(x)
    if "wg" in p:
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    else:
        h = F.gelu(x @ p["wu"], approximate="tanh")   # jax.nn.gelu's default
    return TP.leave(h @ p["wd"]) if tp else h @ p["wd"]
