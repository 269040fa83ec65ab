"""Mixture-of-Experts FFN with capacity-based dispatch (port of
``repro/models/moe.py``), on one device.

A token's router logits go through a softmax, its top ``moe_top_k``
experts are kept and their weights renormalised (DeepSeek-V2). Each
expert takes at most ``C = max(1, ceil(int(T * k * capacity_factor) /
E))`` tokens: the (token, choice) pairs claim slots of a per-expert
buffer in choice-major, token order, and a pair past its expert's
capacity is dropped (it adds nothing). The dispatch fills an (E * C, D)
buffer with each slot's token (zeros where no pair claimed the slot),
the experts run as batched products over the whole (E, C, D) buffer, so
every expert's weights are read whatever the routing, and the combine
gathers each pair's row back and weighs it. Each step is a few
vectorised ops on the device with no host sync (a decode step runs it
in all 26 MoE layers), where the JAX package loops over the k choices
and lets XLA fuse them. Shared experts
(a dense SwiGLU MLP of ``n_shared_experts`` times the expert width) add
to every token. The semantics are the JAX package's, integer logic
included: at a decode step of 4 tokens C is 1, and tokens that pick one
expert are dropped in token order.

Parameters keep the JAX package's tree: ``router`` (D, E) fp32, ``wg``
/ ``wu`` (E, D, F), ``wd`` (E, F, D), ``shared`` {wg, wu, wd}; in a
stacked layer the expert axis goes after the layer axis (``lead``).

Not ported yet: the expert-parallel branches (the ``shard_map`` psum
dispatch and ``_moe_forward_a2a``) wait for the mesh slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def moe_init(generator: torch.Generator, cfg, dtype=torch.float32, *,
             lead: tuple = (), device=None) -> dict:
    d, f, E = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    kw = dict(device=device)
    ex = (*lead, E)
    p = {
        "router": dense_init(generator, d, E, torch.float32, scale=0.02,
                             lead=lead, **kw),
        "wg": dense_init(generator, d, f, dtype, lead=ex, **kw),
        "wu": dense_init(generator, d, f, dtype, lead=ex, **kw),
        "wd": dense_init(generator, f, d, dtype, scale=1.0 / math.sqrt(f),
                         lead=ex, **kw),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "wg": dense_init(generator, d, fs, dtype, lead=lead, **kw),
            "wu": dense_init(generator, d, fs, dtype, lead=lead, **kw),
            "wd": dense_init(generator, fs, d, dtype,
                             scale=1.0 / math.sqrt(fs), lead=lead, **kw)}
    return p


def router_topk(logits: torch.Tensor, k: int):
    """softmax -> top-k -> renormalise: ``(probs, topv, topi)``. The top k
    come from a stable descending sort, so equal probabilities keep the
    lower expert first, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order among equals)."""
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, topv, topi


def load_balance_loss(probs: torch.Tensor, topi: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e (f_e: the share of
    routing choices that picked e; P_e: e's mean probability). The counts
    by ``index_add_`` (exact small integers; ``bincount`` would wait for
    the device to size its output)."""
    idx = topi.reshape(-1)
    counts = torch.zeros((n_experts,), dtype=torch.float32,
                         device=topi.device).index_add_(
        0, idx, torch.ones(idx.shape, dtype=torch.float32,
                           device=topi.device))
    frac = counts / max(topi.numel(), 1)
    return n_experts * torch.sum(frac * probs.mean(dim=0))


def _dispatch_positions(topi: torch.Tensor, n_experts: int,
                        capacity: int) -> torch.Tensor:
    """Per-(token, choice) slot in the per-expert capacity buffer, (T, k)
    int64 in [0, E * C], where E * C means dropped. Choice j's pairs come
    after every pair of choices < j, in token order: a pair's position in
    its expert's queue is the number of earlier pairs, in that choice-
    major order, that picked the same expert. One scan along the pairs of
    an (E, k * T) one-hot gives them all (the JAX package loops over the
    choices with a (T, E) one-hot each: the same counts)."""
    T, k = topi.shape
    e = topi.t().reshape(-1).long()                         # choice-major
    experts = torch.arange(n_experts, device=topi.device)
    cum = torch.cumsum(experts[:, None] == e[None, :], dim=1,
                       dtype=torch.int32)                    # (E, k * T)
    pos = torch.gather(cum, 0, e[None, :])[0] - 1
    slot = torch.where(pos < capacity, e * capacity + pos,
                       n_experts * capacity)
    return slot.view(k, T).t()


def _moe_local(p: dict, cfg, xt: torch.Tensor, *, capacity: int,
               out_dtype, with_aux: bool = True):
    """Dispatch, compute and combine the (T, D) tokens over every expert
    (the JAX package's ``_moe_local`` with e_offset 0 and e_local E, its
    one-device case): ``(out (T, D), aux)``, aux empty without
    ``with_aux``."""
    T, D = xt.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    logits = xt.float() @ p["router"].float()
    probs, topv, topi = router_topk(logits, k)

    slot = _dispatch_positions(topi, E, capacity)                  # (T, k)
    n_slots = E * capacity
    # each slot's token: row T of xt_pad is zeros (an unclaimed slot); the
    # dropped pairs all write the extra entry n_slots, which is cut off
    src = torch.full((n_slots + 1,), T, dtype=torch.long, device=xt.device)
    src[slot.reshape(-1)] = torch.arange(
        T, device=xt.device).repeat_interleave(k)
    xt_pad = torch.cat([xt, xt.new_zeros((1, D))])
    buf = xt_pad[src[:n_slots]].view(E, capacity, D)
    del xt_pad, src
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wu"])
    del buf
    y = torch.bmm(h, p["wd"])                                  # (E, C, D)
    del h
    flat = torch.cat([y.view(n_slots, D), y.new_zeros((1, D))])
    del y
    kept = slot < n_slots
    out = torch.einsum("tkd,tk->td", flat[slot].float(), topv * kept)

    aux = {}
    if with_aux:
        aux = {
            "moe_balance": load_balance_loss(probs, topi, E),
            "moe_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
            "moe_drop_frac": 1.0 - torch.mean(kept.float()),
        }
    return out.to(out_dtype), aux


def capacity(cfg, n_tokens: int, capacity_factor=None) -> int:
    """The per-expert capacity C of a call over ``n_tokens`` tokens."""
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    return max(1, _cdiv(int(n_tokens * cfg.moe_top_k * cf), cfg.n_experts))


def moe_forward(p: dict, cfg, x: torch.Tensor, capacity_factor=None, *,
                with_aux: bool = True):
    """x: (B, S, D) -> ``(out (B, S, D), aux)``: the one-device branch of
    the JAX package's ``moe_forward`` (every expert local), plus the
    shared experts. ``aux``: ``moe_balance``, ``moe_z``,
    ``moe_drop_frac``; empty with ``with_aux=False`` (a decode step drops
    them, as XLA drops the JAX package's unused stats)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    C = capacity(cfg, B * S, capacity_factor)
    out, aux = _moe_local(p, cfg, xt, capacity=C, out_dtype=x.dtype,
                          with_aux=with_aux)
    out = out.reshape(B, S, D)
    if cfg.n_shared_experts:
        sh = p["shared"]
        hs = F.silu(xt @ sh["wg"]) * (xt @ sh["wu"])
        out = out + (hs @ sh["wd"]).reshape(B, S, D)
    return out, aux


def moe_aux_total(cfg, aux: dict) -> torch.Tensor:
    return (cfg.router_aux_weight * aux["moe_balance"]
            + cfg.router_z_weight * aux["moe_z"])
