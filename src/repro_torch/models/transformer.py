"""Layer-program transformer (port of ``repro/models/transformer.py``) for
the dense GQA family: gqa mixer + dense FFN blocks, training
(:func:`lm_loss`) and serving (full-sequence forward, prefill,
single-token decode against per-layer KV caches).

Parameters keep the JAX package's tree and key names: unscanned
``prologue_<i>`` blocks, then ``params["stack"][str(i)]`` for pattern
position i with every leaf stacked over a leading ``pattern_repeats`` axis,
``final_norm`` and ``lm_head``, so a JAX state converts leaf for leaf
(``repro_torch.convert.lm_dense_from_numpy``). The JAX package's
``lax.scan`` over the stack is a Python loop over layer views here; its
``jax.checkpoint`` (``cfg.remat``) is ``torch.utils.checkpoint`` around
each stack layer when grad is enabled, and does not apply to serving.
Token embeddings are not part of the dense parameters: they come from the
embedding PS as activations, and :func:`lm_loss` differentiates them.

Caches keep the JAX tree too (``caches["stack"][str(i)]["attn"]`` with k,
v of shape (R, B, max_len, Hkv, Dh) and len (R, B), ``caches["pos"]``),
but are allocated at ``max_len`` once by :func:`prefill`, which writes the
prompt's K/V into their head, and :func:`decode_step` writes each new
token's K/V into them in place, where the JAX package pads its prefill
caches (``_pad_cache_seq``) and returns new ones each step. The contents
are the same.

Not ported yet: the mla, mamba2 and cross-attention mixers, MoE FFNs (and
their aux loss), the encoder and learned decoder positions
(``dec_pos_emb``).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.models import layers as L


def _check_ported(cfg: ModelConfig):
    for blk in cfg.prologue + cfg.pattern:
        if blk.mixer != "gqa" or blk.ffn != "dense" or blk.cross:
            raise NotImplementedError(
                f"block {blk} is not ported yet: the torch port runs gqa "
                "mixers with dense FFNs")
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models are not ported "
                                  "yet")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(generator, cfg: ModelConfig, blk: BlockCfg, dtype, *,
                lead=(), device=None) -> dict:
    kw = dict(lead=lead, device=device)
    return {"mixer_norm": L.norm_init(cfg, cfg.d_model, **kw),
            "mixer": L.gqa_init(generator, cfg, dtype, **kw),
            "ffn_norm": L.norm_init(cfg, cfg.d_model, **kw),
            "ffn": L.mlp_init(generator, cfg, dtype=dtype, **kw)}


def init_dense(cfg: ModelConfig, generator: torch.Generator,
               dtype=torch.float32, device=None) -> dict:
    """Everything except the embedding table (the PS holds it), random
    from ``generator`` on ``device`` (the generator's by default). Each
    stacked leaf is drawn in one call over its (pattern_repeats, ...)
    shape: the same distribution as the JAX package's per-layer draws,
    other numbers (``jax.random`` streams cannot be reproduced)."""
    _check_ported(cfg)
    device = generator.device if device is None else device
    params: dict = {}
    for i, blk in enumerate(cfg.prologue):
        params[f"prologue_{i}"] = _block_init(generator, cfg, blk, dtype,
                                              device=device)
    params["stack"] = {
        str(i): _block_init(generator, cfg, blk, dtype,
                            lead=(cfg.pattern_repeats,), device=device)
        for i, blk in enumerate(cfg.pattern)}
    params["final_norm"] = L.norm_init(cfg, cfg.d_model, device=device)
    params["lm_head"] = L.dense_init(generator, cfg.d_model,
                                     cfg.padded_vocab, dtype,
                                     scale=1.0 / math.sqrt(cfg.d_model),
                                     device=device)
    return params


def _unstack(tree, n: int) -> list:
    """A stacked tree -> its ``n`` layers' views, each leaf split once
    (``unbind``: autograd then stacks the layers' gradients in one copy,
    where an index per layer would write a stacked-size gradient each)."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][r] for k in tree} for r in range(n)]
    return list(tree.unbind(0))


def _layers(cfg: ModelConfig, params: dict, caches: dict | None):
    """``(stacked, [(parameters, cache), ...])`` in order: each prologue
    block on its own (``stacked`` False), then the pattern's blocks of
    each stack layer."""
    for i in range(len(cfg.prologue)):
        name = f"prologue_{i}"
        yield False, [(params[name], None if caches is None
                       else caches[name])]
    R, n = cfg.pattern_repeats, len(cfg.pattern)
    ps = [_unstack(params["stack"][str(i)], R) for i in range(n)]
    cs = [[None] * R if caches is None
          else _unstack(caches["stack"][str(i)], R) for i in range(n)]
    for r in range(R):
        yield True, [(ps[i][r], cs[i][r]) for i in range(n)]


# ---------------------------------------------------------------------------
# Full sequence
# ---------------------------------------------------------------------------

def _apply_block(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cache: dict | None) -> torch.Tensor:
    """One gqa + dense block; with ``cache`` its attention K/V are written
    into the head of the cache's (B, max_len, Hkv, Dh) buffers and its
    ``len`` set to S."""
    h = L.apply_norm(cfg, p["mixer_norm"], x)
    o, (k, v) = L.gqa_forward(p["mixer"], cfg, h, positions)
    x = x + o
    if cache is not None:
        S = x.shape[1]
        a = cache["attn"]
        a["k"][:, :S] = k.to(a["k"].dtype)
        a["v"][:, :S] = v.to(a["v"].dtype)
        a["len"].fill_(S)
    h = L.apply_norm(cfg, p["ffn_norm"], x)
    return x + L.mlp_forward(p["ffn"], cfg, h)


def _apply_blocks(cfg, blocks, x, positions):
    for p, c in blocks:
        x = _apply_block(cfg, p, x, positions, c)
    return x


def forward(cfg: ModelConfig, params: dict, acts: torch.Tensor,
            positions: torch.Tensor, *, caches: dict | None = None
            ) -> torch.Tensor:
    """acts: (B, S, D) token embeddings from the PS. Returns the hidden
    states after the final norm; with ``caches`` (from :func:`cache_init`)
    every block's K/V are written into them. With ``cfg.remat`` and grad
    enabled, each stack layer is checkpointed (the JAX package's
    ``jax.checkpoint`` of the scanned body): its activations are
    recomputed in the backward, the attention kernel included."""
    _check_ported(cfg)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    x = acts
    for stacked, blocks in _layers(cfg, params, caches):
        if remat and stacked:
            x = checkpoint(_apply_blocks, cfg, blocks, x, positions,
                           use_reentrant=False)
        else:
            x = _apply_blocks(cfg, blocks, x, positions)
    return L.apply_norm(cfg, params["final_norm"], x)


# ---------------------------------------------------------------------------
# Loss (training)
# ---------------------------------------------------------------------------

def lm_loss(cfg: ModelConfig, params: dict, acts: torch.Tensor, targets,
            mask, memory=None):
    """Next-token cross entropy. acts: (B, S, D) embedding activations;
    targets: (B, S) integer; mask: (B, S). The logits in fp32 with the pad
    columns at -1e30, their logsumexp, the target logit (a gather: the
    arithmetic of the JAX package's one-hot sum), and the masked mean over
    ``max(sum(mask), 1)``. Returns ``(loss, {"loss", "ppl_log"})``."""
    if memory is not None or cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models are not ported "
                                  "yet")
    dev = acts.device
    targets = torch.as_tensor(targets, device=dev).long()
    mask = torch.as_tensor(mask, device=dev).float()
    B, S = targets.shape
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    x = forward(cfg, params, acts, positions)
    logits = _logits(cfg, params, x)                         # (B, S, Vp)
    if cfg.padded_vocab > cfg.vocab_size:                    # mask pads
        cols = torch.arange(cfg.padded_vocab, device=dev)
        logits = torch.where(cols < cfg.vocab_size, logits, L.NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (lse - tgt) * mask
    loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"loss": loss, "ppl_log": loss}


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode against per-layer caches
# ---------------------------------------------------------------------------

def cache_init(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> dict:
    _check_ported(cfg)
    caches = {f"prologue_{i}": {"attn": L.gqa_cache_init(
        cfg, batch, max_len, dtype, device=device)}
        for i in range(len(cfg.prologue))}
    caches["stack"] = {str(i): {"attn": L.gqa_cache_init(
        cfg, batch, max_len, dtype, lead=(cfg.pattern_repeats,),
        device=device)} for i in range(len(cfg.pattern))}
    caches["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return caches


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    return (x @ params["lm_head"]).float()


def decode_step(cfg: ModelConfig, params: dict, acts: torch.Tensor,
                caches: dict):
    """One-token decode. acts: (B, 1, D) embedding of the new token.
    Updates ``caches`` in place and returns ``(logits (B, 1, padded_vocab)
    fp32 with the pad columns at -1e30, caches)``."""
    _check_ported(cfg)
    x = acts
    for p, c in (b for _, blocks in _layers(cfg, params, caches)
                 for b in blocks):
        h = L.apply_norm(cfg, p["mixer_norm"], x)
        o, _ = L.gqa_decode(p["mixer"], cfg, h, c["attn"])
        x = x + o
        h = L.apply_norm(cfg, p["ffn_norm"], x)
        x = x + L.mlp_forward(p["ffn"], cfg, h)
    caches["pos"] += 1
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = _logits(cfg, params, x)
    if cfg.padded_vocab > cfg.vocab_size:
        logits[..., cfg.vocab_size:] = L.NEG_INF
    return logits, caches


def prefill(cfg: ModelConfig, params: dict, acts: torch.Tensor,
            max_len: int | None = None):
    """Full-sequence prefill: caches of ``max(max_len, S)`` positions with
    the prompt's K/V in their head, and the last token's logits (B, 1,
    padded_vocab) fp32, the pad columns NOT masked (as in the JAX package:
    the caller slices ``[:vocab_size]``)."""
    B, S, _ = acts.shape
    positions = torch.arange(S, device=acts.device)[None].expand(B, S)
    caches = cache_init(cfg, B, max(S, max_len or 0), acts.dtype,
                        acts.device)
    x = forward(cfg, params, acts, positions, caches=caches)
    caches["pos"].fill_(S)
    return _logits(cfg, params, x[:, -1:]), caches
