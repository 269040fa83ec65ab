"""Layer-program transformer (port of ``repro/models/transformer.py``):
one code path for every architecture of the JAX package (dense GQA,
DeepSeek-V2's MLA + MoE, Mamba-2, the Jamba hybrid, Llama-3.2-Vision's
interleaved tanh-gated cross-attention, the Whisper encoder-decoder):
gqa, mla, mamba2, cross_attn or no mixers, an optional cross-attention
sub-block (``BlockCfg.cross``), dense, MoE or no FFNs; training
(:func:`lm_loss`, with the MoE aux loss) and serving (full-sequence
forward, prefill, single-token decode against per-layer KV, latent, SSM
and cross-attention caches).

Parameters keep the JAX package's tree and key names: unscanned
``prologue_<i>`` blocks, then ``params["stack"][str(i)]`` for pattern
position i with every leaf stacked over a leading ``pattern_repeats`` axis
(a ``cross_attn`` block's 0-d ``xgate`` becomes (R,)), ``final_norm`` and
``lm_head``; an encoder-decoder adds ``encoder`` (``in_proj``, ``pos_emb``,
its own ``stack`` and ``final_norm``) and the learned decoder positions
``dec_pos_emb`` (65,536 rows), so a JAX state converts leaf for leaf
(``repro_torch.convert.lm_dense_from_numpy``). A block without an FFN
(``ffn == "none"``, Mamba-2) has no ``ffn_norm`` either. The JAX package's
``lax.scan`` over the stack is a Python loop over layer views here; its
``jax.checkpoint`` (``cfg.remat``) is ``torch.utils.checkpoint`` around
each stack layer (and each encoder layer, under the encoder's ``remat``)
when grad is enabled, and does not apply to serving. Token embeddings
are not part of the dense parameters: they come from the embedding PS as
activations, and :func:`lm_loss` differentiates them. The memory (image
patches, or an encoder-decoder's frames, which :func:`encode` turns into
the decoder's memory) is an input of :func:`lm_loss` and
:func:`prefill`.

Caches keep the JAX tree too (``caches["stack"][str(i)]["attn"]`` with k,
v of shape (R, B, max_len, Hkv, Dh) and len (R, B), or an mla block's
latent ckv (R, B, max_len, kv_lora_rank) and k_rope (R, B, max_len,
rope_head_dim), or a mamba2 block's ``["ssm"]`` with h (R, B, H, N, P)
fp32 and conv (R, B, K - 1, conv channels); a cross-attention's
``["cross"]`` k, v (R, B, M, Hkv, Dh) of the memory's M positions;
``caches["pos"]``), but are allocated at ``max_len`` once by
:func:`prefill`, which writes the prompt's K/V into their head (the
memory's K/V whole, the SSM state after the prompt), and
:func:`decode_step` writes each new token's K/V (or state) into them in
place, where the JAX package pads its prefill caches (``_pad_cache_seq``)
and returns new ones each step. The contents are the same. A
sliding-window model's prefill cache is that full-length cache too (the
JAX package's padded prefill cache), and its decode writes slot ``len %
S`` of whatever cache it is given: a ring of ``min(max_len, window)``
slots from :func:`cache_init` wraps, a prefill's never does.

A MoE block's aux stats (``moe_balance``, ``moe_z``, ``moe_drop_frac``)
add up over the layers as the JAX package's ``_acc_aux`` adds them.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import tp as TP
from repro_torch.utils import get_mesh, pmax

# learned decoder positions of an encoder-decoder (Whisper style): 64k
# rows, as the JAX package draws them
DEC_POSITIONS = 1 << 16


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(generator, cfg: ModelConfig, blk: BlockCfg, dtype, *,
                lead=(), device=None) -> dict:
    kw = dict(lead=lead, device=device)
    p: dict = {}
    if blk.mixer != "none":
        p["mixer_norm"] = L.norm_init(cfg, cfg.d_model, **kw)
    if blk.mixer in ("gqa", "cross_attn"):
        p["mixer"] = L.gqa_init(generator, cfg, dtype,
                                cross=blk.mixer == "cross_attn", **kw)
    elif blk.mixer == "mla":
        p["mixer"] = L.mla_init(generator, cfg, dtype, **kw)
    elif blk.mixer == "mamba2":
        p["mixer"] = M2.mamba2_init(generator, cfg, dtype, **kw)
    if blk.mixer == "cross_attn":                   # tanh(0): the gate shut
        p["xgate"] = torch.zeros(lead, dtype=torch.float32, device=device)
    if blk.cross:
        p["cross_norm"] = L.norm_init(cfg, cfg.d_model, **kw)
        p["cross"] = L.gqa_init(generator, cfg, dtype, cross=True, **kw)
    if blk.ffn != "none":
        p["ffn_norm"] = L.norm_init(cfg, cfg.d_model, **kw)
        p["ffn"] = (L.mlp_init(generator, cfg, dtype=dtype, **kw)
                    if blk.ffn == "dense" else
                    MOE.moe_init(generator, cfg, dtype, **kw))
    return p


def _stack_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    return {str(i): _block_init(generator, cfg, blk, dtype,
                                lead=(cfg.pattern_repeats,), device=device)
            for i, blk in enumerate(cfg.pattern)}


def init_dense(cfg: ModelConfig, generator: torch.Generator,
               dtype=torch.float32, device=None) -> dict:
    """Everything except the embedding table (the PS holds it), random
    from ``generator`` on ``device`` (the generator's by default). Each
    stacked leaf is drawn in one call over its (pattern_repeats, ...)
    shape: the same distribution as the JAX package's per-layer draws,
    other numbers (``jax.random`` streams cannot be reproduced)."""
    device = generator.device if device is None else device
    params: dict = {}
    for i, blk in enumerate(cfg.prologue):
        params[f"prologue_{i}"] = _block_init(generator, cfg, blk, dtype,
                                              device=device)
    params["stack"] = _stack_init(generator, cfg, dtype, device)
    params["final_norm"] = L.norm_init(cfg, cfg.d_model, device=device)
    params["lm_head"] = L.dense_init(generator, cfg.d_model,
                                     cfg.padded_vocab, dtype,
                                     scale=1.0 / math.sqrt(cfg.d_model),
                                     device=device)
    if cfg.is_encdec:
        params["encoder"] = _init_encoder(cfg.encoder, generator, dtype,
                                          device)
        params["dec_pos_emb"] = L.embed_init(generator, DEC_POSITIONS,
                                             cfg.d_model, dtype,
                                             device=device)
    return params


def _init_encoder(ecfg: ModelConfig, generator, dtype, device) -> dict:
    """The encoder's input projection (d_memory -> d_model), its learned
    positions (n_memory_tokens rows), stacked blocks and final norm."""
    return {"pos_emb": L.embed_init(generator, ecfg.n_memory_tokens,
                                    ecfg.d_model, dtype, device=device),
            "in_proj": L.dense_init(generator, ecfg.d_memory, ecfg.d_model,
                                    dtype, device=device),
            "stack": _stack_init(generator, ecfg, dtype, device),
            "final_norm": L.norm_init(ecfg, ecfg.d_model, device=device)}


def _unstack(tree, n: int) -> list:
    """A stacked tree -> its ``n`` layers' views, each leaf split once
    (``unbind``: autograd then stacks the layers' gradients in one copy,
    where an index per layer would write a stacked-size gradient each)."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][r] for k in tree} for r in range(n)]
    return list(tree.unbind(0))


def _stack_layers(cfg: ModelConfig, stack: dict, caches: dict | None,
                  specs: dict | None = None, cspecs: dict | None = None):
    """Each stack layer's ``[(block config, parameters, cache, (parameter
    specs, cache specs)), ...]``; the specs (one layer's, under a mesh)
    None without a mesh."""
    R, n = cfg.pattern_repeats, len(cfg.pattern)
    ps = [_unstack(stack[str(i)], R) for i in range(n)]
    cs = [[None] * R if caches is None
          else _unstack(caches["stack"][str(i)], R) for i in range(n)]
    sp = [(None if specs is None else TP.unstacked(specs[str(i)]),
           None if cspecs is None else TP.unstacked(cspecs["stack"][str(i)]))
          for i in range(n)]
    for r in range(R):
        yield [(cfg.pattern[i], ps[i][r], cs[i][r], sp[i]) for i in range(n)]


def _layers(cfg: ModelConfig, params: dict, caches: dict | None,
            specs: dict | None = None, cspecs: dict | None = None):
    """``(stacked, [(block config, parameters, cache, specs), ...])`` in
    order: each prologue block on its own (``stacked`` False), then the
    pattern's blocks of each stack layer."""
    for i, blk in enumerate(cfg.prologue):
        name = f"prologue_{i}"
        yield False, [(blk, params[name], None if caches is None
                       else caches[name],
                       (None if specs is None else specs[name],
                        None if cspecs is None else cspecs[name]))]
    stack_specs = None if specs is None else specs["stack"]
    for blocks in _stack_layers(cfg, params["stack"], caches, stack_specs,
                                cspecs):
        yield True, blocks


def _specs(cfg: ModelConfig):
    """The dense leaves' specs under the mesh in scope (None without
    one): under a mesh the parameters are the rank's blocks."""
    return None if get_mesh() is None else TP.dense_specs(cfg)


def _leaf(params: dict, specs, name: str) -> torch.Tensor:
    """A top-level leaf, gathered over ``data`` under a mesh (ZeRO-3)."""
    if specs is None:
        return params[name]
    return TP.gather_params(params[name], specs[name])


def _acc_aux(total: dict, aux: dict) -> dict:
    if not aux:
        return total
    return {k: total[k] + aux[k] if k in total else aux[k] for k in aux}


# ---------------------------------------------------------------------------
# Full sequence
# ---------------------------------------------------------------------------

def _write(buf: torch.Tensor, t: torch.Tensor, spec) -> None:
    """Writes ``t`` (the rank's batch rows, every position and head) into
    the head of the cache buffer ``buf``: under a mesh ``buf`` is the
    rank's block by ``spec`` (its span of the positions or its heads,
    over ``model``), and the rank writes its part of ``t``."""
    if spec is not None:
        for d, e in enumerate(spec):
            if d and e is not None and "model" in ((e,) if isinstance(
                    e, str) else e):
                size = buf.shape[d]
                lo = TP.model_index() * size
                t = t.narrow(d, min(lo, t.shape[d]),
                             max(0, min(size, t.shape[d] - lo)))
    idx = tuple(slice(0, n) for n in t.shape)
    buf[idx] = t.to(buf.dtype)


def _write_cross(cache: dict | None, kv, cspec=None) -> None:
    if cache is not None:
        for key, t in zip(("k", "v"), kv):
            _write(cache["cross"][key], t,
                   None if cspec is None else cspec["cross"][key])


def _apply_block(cfg, blk: BlockCfg, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, cache: dict | None,
                 memory: torch.Tensor | None = None, specs=(None, None)):
    """One block: ``(x, aux)``. With ``cache`` the attention's K/V (gqa)
    or latent ckv / k_rope (mla) are written into the head of the cache's
    max_len buffers and its ``len`` set to S; a mamba2 block writes its
    state after the last position; a cross-attention (the ``cross_attn``
    mixer, tanh(``xgate``)-gated, or the ``cross`` sub-block after the
    mixer) attends to ``memory`` and writes the memory's K/V. ``aux``
    holds a MoE FFN's stats, empty for a dense one or none. Under a mesh
    (``specs``: the block's parameter and cache specs) the block's leaves
    are gathered over ``data`` first (ZeRO-3) and each rank writes its
    block of the caches."""
    pspec, cspec = specs
    p = TP.gather_params(p, pspec)
    S = x.shape[1]
    full = cache is not None
    if blk.mixer != "none":
        h = L.apply_norm(cfg, p["mixer_norm"], x)
    if blk.mixer == "mamba2":
        if cache is None:
            o = M2.mamba2_forward(p["mixer"], cfg, h)
        else:
            o, st = M2.mamba2_forward(p["mixer"], cfg, h, return_state=True)
            for key, t in st.items():
                _write(cache["ssm"][key], t,
                       None if cspec is None else cspec["ssm"][key])
        x = x + o
    elif blk.mixer == "cross_attn":
        o, kv = L.cross_attn_forward(p["mixer"], cfg, h, memory,
                                     full_kv=full)
        x = x + torch.tanh(p["xgate"]).to(x.dtype) * o
        _write_cross(cache, kv, cspec)
    elif blk.mixer in ("gqa", "mla"):
        if blk.mixer == "gqa":
            o, (k, v) = L.gqa_forward(p["mixer"], cfg, h, positions,
                                      full_kv=full)
            new = {"k": k, "v": v}
        else:
            o, new = L.mla_forward(p["mixer"], cfg, h, positions)
            new.pop("len")
        x = x + o
        if cache is not None:
            a = cache["attn"]
            for key, t in new.items():
                _write(a[key], t, None if cspec is None
                       else cspec["attn"][key])
            a["len"].fill_(S)
    if blk.cross:
        h = L.apply_norm(cfg, p["cross_norm"], x)
        o, kv = L.cross_attn_forward(p["cross"], cfg, h, memory,
                                     full_kv=full)
        x = x + o
        _write_cross(cache, kv, cspec)
    if blk.ffn == "none":
        return x, {}
    h = L.apply_norm(cfg, p["ffn_norm"], x)
    if blk.ffn == "dense":
        return x + L.mlp_forward(p["ffn"], cfg, h), {}
    o, aux = MOE.moe_forward(p["ffn"], cfg, h)
    return x + o, aux


def _apply_blocks(cfg, blocks, x, positions, memory):
    aux_total: dict = {}
    for blk, p, c, sp in blocks:
        x, aux = _apply_block(cfg, blk, p, x, positions, c, memory, sp)
        aux_total = _acc_aux(aux_total, aux)
    return x, aux_total


def forward(cfg: ModelConfig, params: dict, acts: torch.Tensor,
            positions: torch.Tensor, memory: torch.Tensor | None = None, *,
            caches: dict | None = None, cspecs: dict | None = None):
    """acts: (B, S, D) token embeddings from the PS; positions (B, S);
    memory (B, M, d_memory) for cross-attention (an encoder-decoder's
    encoded frames, :func:`encode`). Returns ``(hidden states after the
    final norm, aux)``, ``aux`` the MoE stats summed over the layers
    (empty without MoE blocks); with ``caches`` (from :func:`cache_init`)
    every block's K/V or latents are written into them. An
    encoder-decoder adds ``dec_pos_emb[positions]`` first. With
    ``cfg.remat`` and grad enabled, each stack layer is checkpointed (the
    JAX package's ``jax.checkpoint`` of the scanned body): its activations
    are recomputed in the backward, the attention kernel included. Under
    a mesh ``params`` are the rank's blocks (``tp``), each block's leaves
    gathered over ``data`` inside its checkpoint, so the recompute gathers
    them again, and ``cspecs`` are the caches' specs."""
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    x, aux_total = acts, {}
    specs = _specs(cfg)
    if cfg.is_encdec:
        x = x + _leaf(params, specs, "dec_pos_emb")[positions].to(x.dtype)
    for stacked, blocks in _layers(cfg, params, caches, specs, cspecs):
        if remat and stacked:
            x, aux = checkpoint(_apply_blocks, cfg, blocks, x, positions,
                                memory, use_reentrant=False)
        else:
            x, aux = _apply_blocks(cfg, blocks, x, positions, memory)
        aux_total = _acc_aux(aux_total, aux)
    return L.apply_norm(cfg, params["final_norm"], x), aux_total


def _encoder_layer(ecfg: ModelConfig, blocks, x: torch.Tensor):
    """One encoder layer: per block a non-causal self-attention (no RoPE,
    no window, no cap, as in JAX) and the MLP, each pre-normed (their
    leaves gathered over ``data`` first under a mesh)."""
    for _, p, _, (pspec, _) in blocks:
        p = TP.gather_params(p, pspec)
        h = L.apply_norm(ecfg, p["mixer_norm"], x)
        x = x + L.cross_attn_forward(p["mixer"], ecfg, h, h)[0]
        h = L.apply_norm(ecfg, p["ffn_norm"], x)
        x = x + L.mlp_forward(p["ffn"], ecfg, h)
    return x


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """Whisper-style encoder over precomputed (stub) frame embeddings:
    frames (B, M, d_memory) -> memory (B, M, D): ``in_proj``, the learned
    ``pos_emb`` of the first M positions, the encoder's layers (each
    checkpointed under the encoder's ``remat`` when grad is enabled, as
    the JAX package checkpoints its scanned body) and its final norm.
    Every layer's attention is the kernel on the card (Sq = Sk = M)."""
    ecfg, enc = cfg.encoder, params["encoder"]
    specs = _specs(cfg)
    especs = None if specs is None else specs["encoder"]
    x = frames @ _leaf(enc, especs, "in_proj")
    x = x + _leaf(enc, especs, "pos_emb")[None, :x.shape[1]].to(x.dtype)
    remat = ecfg.remat and torch.is_grad_enabled()
    for blocks in _stack_layers(ecfg, enc["stack"], None,
                                None if especs is None else especs["stack"]):
        x = (checkpoint(_encoder_layer, ecfg, blocks, x, use_reentrant=False)
             if remat else _encoder_layer(ecfg, blocks, x))
    return L.apply_norm(ecfg, enc["final_norm"], x)


def _memory(cfg: ModelConfig, params: dict, memory, like: torch.Tensor):
    """The memory the cross-attentions read: ``memory`` (numpy or a
    tensor) on ``like``'s device and dtype, encoded first for an
    encoder-decoder; None without a memory."""
    if memory is None:
        return None
    memory = torch.as_tensor(memory, device=like.device, dtype=like.dtype)
    return encode(cfg, params, memory) if cfg.is_encdec else memory


# ---------------------------------------------------------------------------
# Loss (training)
# ---------------------------------------------------------------------------

def lm_loss(cfg: ModelConfig, params: dict, acts: torch.Tensor, targets,
            mask, memory=None):
    """Next-token cross entropy. acts: (B, S, D) embedding activations;
    targets: (B, S) integer; mask: (B, S); memory: (B, M, d_memory)
    patches or, for an encoder-decoder, frames (numpy or a tensor, moved
    to the activations' device and dtype), encoded first. The logits in
    fp32 with the pad columns at -1e30, their logsumexp, the target logit
    (a gather: the arithmetic of the JAX package's one-hot sum), and the
    masked mean over ``max(sum(mask), 1)``. With MoE blocks the loss adds
    ``moe_aux_total`` of the stats averaged over the layers, as the JAX
    package does. Returns ``(loss, {"loss" (the cross entropy), "ppl_log"
    and, with MoE blocks, "moe_balance", "moe_z", "moe_drop_frac" summed
    over the layers})``."""
    dev = acts.device
    targets = torch.as_tensor(targets, device=dev).long()
    mask = torch.as_tensor(mask, device=dev).float()
    B, S = targets.shape
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    memory = _memory(cfg, params, memory, acts)
    x, aux = forward(cfg, params, acts, positions, memory)
    head = _leaf(params, _specs(cfg), "lm_head")
    if TP.split(head, cfg.padded_vocab):
        lse, tgt = _vocab_parallel_ce(cfg, head, x, targets)
    else:
        logits = (x @ head).float()                          # (B, S, Vp)
        if cfg.padded_vocab > cfg.vocab_size:                # mask pads
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


def _vocab_parallel_ce(cfg: ModelConfig, head: torch.Tensor, x, targets):
    """The cross entropy's logsumexp and target logit, (B, S) each, with
    ``head`` this rank's block of vocabulary columns (Megatron's
    vocab-parallel cross entropy): the maximum over every rank's logits
    (a ``pmax`` over ``model``, outside the gradient as in a logsumexp),
    the sum of the shifted exponentials over ``model``, and the target
    logit from the rank that owns its column; the pad columns masked by
    their global index."""
    Vl = head.shape[1]
    lo = TP.model_index() * Vl
    logits = (TP.enter(x) @ head).float()                    # (B, S, Vl)
    if cfg.padded_vocab > cfg.vocab_size:
        cols = lo + torch.arange(Vl, device=x.device)
        logits = torch.where(cols < cfg.vocab_size, logits, L.NEG_INF)
    m = pmax(logits.detach().amax(dim=-1).contiguous(), TP.MODEL)
    sumexp = TP.leave(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    lse = m + torch.log(sumexp)
    local = targets - lo
    mine = (local >= 0) & (local < Vl)
    tgt = torch.gather(logits, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    tgt = TP.leave(torch.where(mine, tgt, 0.0))
    return lse, tgt


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode against per-layer caches
# ---------------------------------------------------------------------------

def _block_cache_init(cfg, blk: BlockCfg, batch, max_len, dtype,
                      memory_len, window, *, lead=(), device=None) -> dict:
    kw = dict(lead=lead, device=device)
    c = {}
    if blk.mixer == "mamba2":       # fixed-size: no max_len
        c["ssm"] = M2.mamba2_cache_init(cfg, batch, dtype, **kw)
    elif blk.mixer == "gqa":
        c["attn"] = L.gqa_cache_init(cfg, batch, max_len, dtype,
                                     window=window, **kw)
    elif blk.mixer == "mla":
        c["attn"] = L.mla_cache_init(cfg, batch, max_len, dtype, **kw)
    if blk.mixer == "cross_attn" or blk.cross:
        shape = (*lead, batch, memory_len, cfg.n_kv_heads, cfg.head_dim)
        c["cross"] = {k: torch.zeros(shape, dtype=dtype, device=device)
                      for k in ("k", "v")}
    return c


def cache_init(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None, memory_len: int = 0, *,
               window: int | None = None) -> dict:
    """Zero caches for ``batch`` sequences of up to ``max_len`` positions
    and a memory of ``memory_len`` (the JAX package's ``cache_init``): a
    sliding-window gqa cache is a ring of ``min(max_len, window)`` slots,
    ``window`` the config's unless given (0: full length, as the
    prefill's)."""
    args = (batch, max_len, dtype, memory_len, window)
    caches = {f"prologue_{i}": _block_cache_init(cfg, blk, *args,
                                                 device=device)
              for i, blk in enumerate(cfg.prologue)}
    caches["stack"] = {str(i): _block_cache_init(
        cfg, blk, *args, lead=(cfg.pattern_repeats,), device=device)
        for i, blk in enumerate(cfg.pattern)}
    caches["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return caches


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """(..., padded_vocab) fp32 logits; under tensor parallelism the
    rank's columns gathered over ``model`` (serving takes the argmax of
    every column)."""
    head = _leaf(params, _specs(cfg), "lm_head")
    if TP.split(head, cfg.padded_vocab):
        return TP.gather_model((x @ head).float())
    return (x @ head).float()


def _cross_decode(p: dict, cfg, x: torch.Tensor, ckv: dict) -> torch.Tensor:
    """The decode's cross-attention of (B, 1, D) against the memory's
    cached K/V (B, M, Hkv, Dh): the JAX package's ``grouped_attention`` at
    Sq = 1 is ``_attn_naive``, whose arithmetic is the plain
    :func:`~repro_torch.models.layers.decode_attention` with every one of
    the M positions valid (decode attention is plain torch). Under a mesh
    whose ``model`` axis shards the memory's positions (the cache spec's
    rule) the rank attends over its span and the spans combine as the
    sequence-sharded decode combines them; under tensor parallelism the
    step's heads are gathered and leave through the rank's ``wo`` rows."""
    from repro_torch.models import decode_dist as DD
    B = x.shape[0]
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    if TP.split(p["wq"], cfg.n_heads * Dh):
        q = TP.gather_model(x @ p["wq"]).reshape(B, 1, -1, Dh)
        if cfg.qk_norm:
            q = L.rmsnorm(q, p["q_norm"]["w"], cfg.norm_eps)
    else:
        q = x @ p["wq"]
        if cfg.qk_norm:
            q = L.rmsnorm(q.reshape(B, 1, -1, Dh), p["q_norm"]["w"],
                          cfg.norm_eps)
    q = q.reshape(B, 1, Hkv, -1, Dh)
    M = ckv["k"].shape[1]
    if DD.have_model_axis() and M != _memory_len(cfg):   # its span of M
        s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(),
                         ckv["k"].float()) / math.sqrt(Dh)
        o = DD._combine(s, ckv["v"], "bhgqk,bkhd->bhgqd")
        o = o.permute(0, 3, 1, 2, 4).to(q.dtype)
    else:
        n = torch.full((B,), M, dtype=torch.int32, device=x.device)
        o = L.decode_attention(q, ckv["k"], ckv["v"], n,
                               scale=1.0 / math.sqrt(Dh))
    return L.decode_out(p, cfg, o.reshape(B, 1, -1), Dh)


def _memory_len(cfg: ModelConfig) -> int:
    return cfg.encoder.n_memory_tokens if cfg.is_encdec \
        else cfg.n_memory_tokens


def decode_step(cfg: ModelConfig, params: dict, acts: torch.Tensor,
                caches: dict):
    """One-token decode. acts: (B, 1, D) embedding of the new token.
    Updates ``caches`` in place and returns ``(logits (B, 1, padded_vocab)
    fp32 with the pad columns at -1e30, caches)``. A MoE FFN routes the B
    tokens of the step together (its capacity from B), as in the JAX
    package. An encoder-decoder adds ``dec_pos_emb[pos]``; the
    cross-attentions read the memory's K/V that the prefill cached."""
    x = acts
    specs = _specs(cfg)
    if cfg.is_encdec:
        x = x + _leaf(params, specs, "dec_pos_emb")[
            caches["pos"].long()][:, None].to(x.dtype)
    for blk, p, c, sp in (b for _, blocks in _layers(cfg, params, caches,
                                                     specs)
                          for b in blocks):
        p = TP.gather_params(p, sp[0])
        if blk.mixer != "none":
            h = L.apply_norm(cfg, p["mixer_norm"], x)
        if blk.mixer == "mamba2":
            x = x + M2.mamba2_decode(p["mixer"], cfg, h, c["ssm"])[0]
        elif blk.mixer == "cross_attn":
            o = _cross_decode(p["mixer"], cfg, h, c["cross"])
            x = x + torch.tanh(p["xgate"]).to(x.dtype) * o
        elif blk.mixer in ("gqa", "mla"):
            decode = L.gqa_decode if blk.mixer == "gqa" else L.mla_decode
            x = x + decode(p["mixer"], cfg, h, c["attn"])[0]
        if blk.cross:
            h = L.apply_norm(cfg, p["cross_norm"], x)
            x = x + _cross_decode(p["cross"], cfg, h, c["cross"])
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


def local_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.float32, device=None, memory_len: int = 0,
                     *, window: int | None = None):
    """``(caches, specs)``: :func:`cache_init`'s caches as the rank's
    blocks under the mesh in scope (``partition.cache_specs`` fitted to
    the global shapes: the positions, latents or SSM heads over
    ``model``), ``batch`` being the rank's own rows, and the fitted specs;
    ``(cache_init(...), None)`` without a mesh."""
    from repro_torch.sharding import partition as SP
    mesh = get_mesh()
    if mesh is None:
        return cache_init(cfg, batch, max_len, dtype, device, memory_len,
                          window=window), None
    meta = cache_init(cfg, batch, max_len, dtype, torch.device("meta"),
                      memory_len, window=window)

    def fit(spec, leaf):        # the batch rows are the rank's already
        spec = SP._fit(spec, mesh, leaf)
        return SP.P(*(e if "model" in ((e,) if isinstance(e, str)
                                      else (e or ())) else None
                      for e in spec))
    specs = SP._zip_map(fit, SP.cache_specs(meta, cfg), meta)

    def alloc(spec, leaf):
        shape = [n // (TP.n_model() if e is not None else 1)
                 for n, e in zip(leaf.shape, list(spec) + [None] * 8)]
        return torch.zeros(shape, dtype=leaf.dtype, device=device)
    return SP._zip_map(alloc, specs, meta), specs


def prefill(cfg: ModelConfig, params: dict, acts: torch.Tensor,
            memory=None, max_len: int | None = None):
    """Full-sequence prefill: caches of ``max(max_len, S)`` positions with
    the prompt's K/V (or latents) in their head (full length with a
    sliding window too: the JAX package's padded prefill cache), the
    memory's K/V in the cross-attention caches (``memory`` as
    :func:`lm_loss` takes it, encoded first for an encoder-decoder), and
    the last token's logits (B, 1, padded_vocab) fp32, the pad columns
    NOT masked (as in the JAX package: the caller slices
    ``[:vocab_size]``). Under a mesh the caches are the rank's blocks
    (:func:`local_cache_init`; a full-length cache needs a length that
    ``cache_specs`` shards over ``model``, which the decode reads as its
    span)."""
    B, S, _ = acts.shape
    positions = torch.arange(S, device=acts.device)[None].expand(B, S)
    memory = _memory(cfg, params, memory, acts)
    caches, cspecs = local_cache_init(
        cfg, B, max(S, max_len or 0), acts.dtype, acts.device,
        0 if memory is None else memory.shape[1], window=0)
    x, _ = forward(cfg, params, acts, positions, memory, caches=caches,
                   cspecs=cspecs)
    caches["pos"].fill_(S)
    return _logits(cfg, params, x[:, -1:]), caches
