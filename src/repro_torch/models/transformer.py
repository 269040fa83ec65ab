"""Layer-program transformer (port of ``repro/models/transformer.py``) for
the dense GQA family, DeepSeek-V2, Mamba-2 and the Jamba hybrid: gqa, mla
or mamba2 mixers with dense, MoE or no FFNs, training (:func:`lm_loss`,
with the MoE aux loss) and serving (full-sequence forward, prefill,
single-token decode against per-layer KV, latent or SSM caches).

Parameters keep the JAX package's tree and key names: unscanned
``prologue_<i>`` blocks, then ``params["stack"][str(i)]`` for pattern
position i with every leaf stacked over a leading ``pattern_repeats`` axis,
``final_norm`` and ``lm_head``, so a JAX state converts leaf for leaf
(``repro_torch.convert.lm_dense_from_numpy``). A block without an FFN
(``ffn == "none"``, Mamba-2) has no ``ffn_norm`` either. The JAX package's
``lax.scan`` over the stack is a Python loop over layer views here; its
``jax.checkpoint`` (``cfg.remat``) is ``torch.utils.checkpoint`` around
each stack layer when grad is enabled, and does not apply to serving.
Token embeddings are not part of the dense parameters: they come from the
embedding PS as activations, and :func:`lm_loss` differentiates them.

Caches keep the JAX tree too (``caches["stack"][str(i)]["attn"]`` with k,
v of shape (R, B, max_len, Hkv, Dh) and len (R, B), or an mla block's
latent ckv (R, B, max_len, kv_lora_rank) and k_rope (R, B, max_len,
rope_head_dim), or a mamba2 block's ``["ssm"]`` with h (R, B, H, N, P)
fp32 and conv (R, B, K - 1, conv channels); ``caches["pos"]``), but are
allocated at ``max_len`` once by :func:`prefill`, which writes the
prompt's K/V into their head (and the SSM state after the prompt), and
:func:`decode_step` writes each new token's K/V (or state) into them in
place, where the JAX package pads its prefill caches (``_pad_cache_seq``)
and returns new ones each step. The contents are the same.

A MoE block's aux stats (``moe_balance``, ``moe_z``, ``moe_drop_frac``)
add up over the layers as the JAX package's ``_acc_aux`` adds them.

Not ported yet: the cross-attention mixers, the encoder and learned
decoder positions (``dec_pos_emb``).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE

_MIXER_INIT = {"gqa": L.gqa_init, "mla": L.mla_init,
               "mamba2": M2.mamba2_init}


def _check_ported(cfg: ModelConfig):
    for blk in cfg.prologue + cfg.pattern:
        if blk.mixer not in _MIXER_INIT or \
                blk.ffn not in ("dense", "moe", "none") or blk.cross:
            raise NotImplementedError(
                f"block {blk} is not ported yet: the torch port runs gqa, "
                "mla and mamba2 mixers with dense, MoE or no FFNs")
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models are not ported "
                                  "yet")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(generator, cfg: ModelConfig, blk: BlockCfg, dtype, *,
                lead=(), device=None) -> dict:
    kw = dict(lead=lead, device=device)
    p = {"mixer_norm": L.norm_init(cfg, cfg.d_model, **kw),
         "mixer": _MIXER_INIT[blk.mixer](generator, cfg, dtype, **kw)}
    if blk.ffn != "none":
        p["ffn_norm"] = L.norm_init(cfg, cfg.d_model, **kw)
        p["ffn"] = (L.mlp_init(generator, cfg, dtype=dtype, **kw)
                    if blk.ffn == "dense" else
                    MOE.moe_init(generator, cfg, dtype, **kw))
    return p


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
    """``(stacked, [(block config, parameters, cache), ...])`` in order:
    each prologue block on its own (``stacked`` False), then the pattern's
    blocks of each stack layer."""
    for i, blk in enumerate(cfg.prologue):
        name = f"prologue_{i}"
        yield False, [(blk, params[name], None if caches is None
                       else caches[name])]
    R, n = cfg.pattern_repeats, len(cfg.pattern)
    ps = [_unstack(params["stack"][str(i)], R) for i in range(n)]
    cs = [[None] * R if caches is None
          else _unstack(caches["stack"][str(i)], R) for i in range(n)]
    for r in range(R):
        yield True, [(cfg.pattern[i], ps[i][r], cs[i][r]) for i in range(n)]


def _acc_aux(total: dict, aux: dict) -> dict:
    if not aux:
        return total
    return {k: total[k] + aux[k] if k in total else aux[k] for k in aux}


# ---------------------------------------------------------------------------
# Full sequence
# ---------------------------------------------------------------------------

def _apply_block(cfg, blk: BlockCfg, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, cache: dict | None):
    """One block: ``(x, aux)``. With ``cache`` the attention's K/V (gqa)
    or latent ckv / k_rope (mla) are written into the head of the cache's
    max_len buffers and its ``len`` set to S; a mamba2 block writes its
    state after the last position. ``aux`` holds a MoE FFN's stats, empty
    for a dense one or none."""
    S = x.shape[1]
    h = L.apply_norm(cfg, p["mixer_norm"], x)
    if blk.mixer == "mamba2":
        if cache is None:
            o = M2.mamba2_forward(p["mixer"], cfg, h)
        else:
            o, st = M2.mamba2_forward(p["mixer"], cfg, h, return_state=True)
            for key, t in st.items():
                cache["ssm"][key].copy_(t)
        x = x + o
    else:
        if blk.mixer == "gqa":
            o, (k, v) = L.gqa_forward(p["mixer"], cfg, h, positions)
            new = {"k": k, "v": v}
        else:
            o, new = L.mla_forward(p["mixer"], cfg, h, positions)
            new.pop("len")
        x = x + o
        if cache is not None:
            a = cache["attn"]
            for key, t in new.items():
                a[key][:, :S] = t.to(a[key].dtype)
            a["len"].fill_(S)
    if blk.ffn == "none":
        return x, {}
    h = L.apply_norm(cfg, p["ffn_norm"], x)
    if blk.ffn == "dense":
        return x + L.mlp_forward(p["ffn"], cfg, h), {}
    o, aux = MOE.moe_forward(p["ffn"], cfg, h)
    return x + o, aux


def _apply_blocks(cfg, blocks, x, positions):
    aux_total: dict = {}
    for blk, p, c in blocks:
        x, aux = _apply_block(cfg, blk, p, x, positions, c)
        aux_total = _acc_aux(aux_total, aux)
    return x, aux_total


def forward(cfg: ModelConfig, params: dict, acts: torch.Tensor,
            positions: torch.Tensor, *, caches: dict | None = None):
    """acts: (B, S, D) token embeddings from the PS. Returns ``(hidden
    states after the final norm, aux)``, ``aux`` the MoE stats summed over
    the layers (empty without MoE blocks); with ``caches`` (from
    :func:`cache_init`) every block's K/V or latents are written into
    them. With ``cfg.remat`` and grad enabled, each stack layer is
    checkpointed (the JAX package's ``jax.checkpoint`` of the scanned
    body): its activations are recomputed in the backward, the attention
    kernel included."""
    _check_ported(cfg)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    x, aux_total = acts, {}
    for stacked, blocks in _layers(cfg, params, caches):
        if remat and stacked:
            x, aux = checkpoint(_apply_blocks, cfg, blocks, x, positions,
                                use_reentrant=False)
        else:
            x, aux = _apply_blocks(cfg, blocks, x, positions)
        aux_total = _acc_aux(aux_total, aux)
    return L.apply_norm(cfg, params["final_norm"], x), aux_total


# ---------------------------------------------------------------------------
# Loss (training)
# ---------------------------------------------------------------------------

def lm_loss(cfg: ModelConfig, params: dict, acts: torch.Tensor, targets,
            mask, memory=None):
    """Next-token cross entropy. acts: (B, S, D) embedding activations;
    targets: (B, S) integer; mask: (B, S). The logits in fp32 with the pad
    columns at -1e30, their logsumexp, the target logit (a gather: the
    arithmetic of the JAX package's one-hot sum), and the masked mean over
    ``max(sum(mask), 1)``. With MoE blocks the loss adds
    ``moe_aux_total`` of the stats averaged over the layers, as the JAX
    package does. Returns ``(loss, {"loss" (the cross entropy), "ppl_log"
    and, with MoE blocks, "moe_balance", "moe_z", "moe_drop_frac" summed
    over the layers})``."""
    if memory is not None or cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models are not ported "
                                  "yet")
    dev = acts.device
    targets = torch.as_tensor(targets, device=dev).long()
    mask = torch.as_tensor(mask, device=dev).float()
    B, S = targets.shape
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    x, aux = forward(cfg, params, acts, positions)
    logits = _logits(cfg, params, x)                         # (B, S, Vp)
    if cfg.padded_vocab > cfg.vocab_size:                    # mask pads
        cols = torch.arange(cfg.padded_vocab, device=dev)
        logits = torch.where(cols < cfg.vocab_size, logits, L.NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (lse - tgt) * mask
    loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    metrics = {"loss": loss, "ppl_log": loss}
    if aux:
        n = max(cfg.n_layers, 1)
        loss = loss + MOE.moe_aux_total(
            cfg, {k: v / n for k, v in aux.items()})
        metrics.update(aux)
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode against per-layer caches
# ---------------------------------------------------------------------------

def _block_cache_init(cfg, blk: BlockCfg, batch, max_len, dtype, *,
                      lead=(), device=None) -> dict:
    if blk.mixer == "mamba2":       # fixed-size: no max_len
        return {"ssm": M2.mamba2_cache_init(cfg, batch, dtype, lead=lead,
                                            device=device)}
    init = L.gqa_cache_init if blk.mixer == "gqa" else L.mla_cache_init
    return {"attn": init(cfg, batch, max_len, dtype, lead=lead,
                         device=device)}


def cache_init(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> dict:
    _check_ported(cfg)
    caches = {f"prologue_{i}": _block_cache_init(
        cfg, blk, batch, max_len, dtype, device=device)
        for i, blk in enumerate(cfg.prologue)}
    caches["stack"] = {str(i): _block_cache_init(
        cfg, blk, batch, max_len, dtype, lead=(cfg.pattern_repeats,),
        device=device) for i, blk in enumerate(cfg.pattern)}
    caches["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return caches


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    return (x @ params["lm_head"]).float()


def decode_step(cfg: ModelConfig, params: dict, acts: torch.Tensor,
                caches: dict):
    """One-token decode. acts: (B, 1, D) embedding of the new token.
    Updates ``caches`` in place and returns ``(logits (B, 1, padded_vocab)
    fp32 with the pad columns at -1e30, caches)``. A MoE FFN routes the B
    tokens of the step together (its capacity from B), as in the JAX
    package."""
    _check_ported(cfg)
    x = acts
    for blk, p, c in (b for _, blocks in _layers(cfg, params, caches)
                      for b in blocks):
        h = L.apply_norm(cfg, p["mixer_norm"], x)
        if blk.mixer == "mamba2":
            o, _ = M2.mamba2_decode(p["mixer"], cfg, h, c["ssm"])
        else:
            decode = L.gqa_decode if blk.mixer == "gqa" else L.mla_decode
            o, _ = decode(p["mixer"], cfg, h, c["attn"])
        x = x + o
        if blk.ffn == "none":
            continue
        h = L.apply_norm(cfg, p["ffn_norm"], x)
        if blk.ffn == "dense":
            x = x + L.mlp_forward(p["ffn"], cfg, h)
        else:
            x = x + MOE.moe_forward(p["ffn"], cfg, h, with_aux=False)[0]
    caches["pos"] += 1
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = _logits(cfg, params, x)
    if cfg.padded_vocab > cfg.vocab_size:
        logits[..., cfg.vocab_size:] = L.NEG_INF
    return logits, caches


def prefill(cfg: ModelConfig, params: dict, acts: torch.Tensor,
            max_len: int | None = None):
    """Full-sequence prefill: caches of ``max(max_len, S)`` positions with
    the prompt's K/V (or latents) in their head, and the last token's
    logits (B, 1, padded_vocab) fp32, the pad columns NOT masked (as in
    the JAX package: the caller slices ``[:vocab_size]``)."""
    B, S, _ = acts.shape
    positions = torch.arange(S, device=acts.device)[None].expand(B, S)
    caches = cache_init(cfg, B, max(S, max_len or 0), acts.dtype,
                        acts.device)
    x, _ = forward(cfg, params, acts, positions, caches=caches)
    caches["pos"].fill_(S)
    return _logits(cfg, params, x[:, -1:]), caches
