"""Mixture-of-Experts FFN with capacity-based dispatch and expert
parallelism (port of ``repro/models/moe.py``).

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

Under a mesh with a ``model`` axis (``utils.set_mesh``) the experts are
sharded over it, and each rank passes its blocks: its (B_local, S, D)
block of the batch (sharded over the batch axes, replicated over
``model``) and its E / n experts (``_moe_param_specs``, or the LM's
``dense_param_specs``, whose shared experts are tensor-parallel: column
blocks of ``wg`` / ``wu``, rows of ``wd``). Both dispatches
differentiate: the collectives are the autograd pairs of ``utils`` (the
routed tokens and the router enter the split work through Megatron's f,
the experts' sums leave through its g, the all-to-alls' backward is the
reversed all-to-all, the spans' gather keeps each rank's span of the
gradient).
Two dispatches, as in the JAX package, chosen by ``MOE_DISPATCH``
(``REPRO_MOE_DISPATCH``):

* ``'psum'``: every model rank routes the same local tokens but runs only
  its own experts (capacity from the local token count), a sum over
  ``model`` combines their contributions, and the shared experts are
  added after it. One (T_local, D) all-reduce a layer.
* ``'a2a'``: each model rank routes its own S / n span of the sequence,
  ships each routed token to its expert's rank in per-destination buckets
  and gets the results back (two all-to-alls), with per-expert capacity
  buffers on the expert's rank. The JAX layer returns the span (its
  residual stream is sequence-sharded); the port's residual is replicated
  over ``model``, so the spans are gathered back over ``model``, which is
  the reshard XLA makes at that boundary.

The aux statistics are each rank's over its tokens, averaged over
``model`` and the batch axes. Their backward takes 1 / n of the gradient
to each rank's statistics (n the model ranks; the router's gradient is
then summed over ``model``), the batch axes' mean being the trainer's
mean of the gradients over the batch ranks.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from repro_torch.models import tp as TP
from repro_torch.models.layers import dense_init
from repro_torch.utils import (_mesh_axis_names, all_to_all,
                               all_to_all_grad, axis_size, batch_axes,
                               flat_index, gather_split, psum, tree_map)

# token dispatch strategy over the 'model' axis: 'psum' (baseline, tokens
# replicated over the model ranks) or 'a2a' (routed tokens sent to their
# expert's rank and back)
MOE_DISPATCH = os.environ.get("REPRO_MOE_DISPATCH", "psum")


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
               out_dtype, with_aux: bool = True, e_offset: int = 0,
               e_local: int | None = None, router=None):
    """Dispatch, compute and combine the (T, D) tokens over the
    ``e_local`` experts from ``e_offset`` that ``p`` holds (every expert
    by default, the one-device case): ``(out (T, D), aux)``, zeros where
    a token's choice went to another rank's expert; aux empty without
    ``with_aux``."""
    T, D = xt.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    e_local = E if e_local is None else e_local
    router = p["router"] if router is None else router
    logits = xt.float() @ router.float()
    probs, topv, topi = router_topk(logits, k)

    slot_all = _dispatch_positions(topi, E, capacity)              # (T, k)
    n_slots = e_local * capacity
    slot = slot_all
    if e_local != E:       # keep the slots of this rank's experts
        lo = e_offset * capacity
        slot = torch.where((slot_all >= lo) & (slot_all < lo + n_slots),
                           slot_all - lo, n_slots)
    # each slot's token: row T of xt_pad is zeros (an unclaimed slot); the
    # dropped pairs all write the extra entry n_slots, which is cut off
    src = torch.full((n_slots + 1,), T, dtype=torch.long, device=xt.device)
    src[slot.reshape(-1)] = torch.arange(
        T, device=xt.device).repeat_interleave(k)
    xt_pad = torch.cat([xt, xt.new_zeros((1, D))])
    buf = xt_pad[src[:n_slots]].view(e_local, capacity, D)
    del xt_pad, src
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wu"])
    del buf
    y = torch.bmm(h, p["wd"])                            # (e_local, C, D)
    del h
    flat = torch.cat([y.view(n_slots, D), y.new_zeros((1, D))])
    del y
    kept = slot < n_slots
    out = torch.einsum("tkd,tk->td", flat[slot].float(), topv * kept)

    aux = {}
    if with_aux:
        aux = _aux(probs, topi, logits, E, slot_all < E * capacity)
    return out.to(out_dtype), aux


def _aux(probs, topi, logits, n_experts: int, kept) -> dict:
    return {
        "moe_balance": load_balance_loss(probs, topi, n_experts),
        "moe_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "moe_drop_frac": 1.0 - torch.mean(kept.float()),
    }


def _shared(p: dict, xt: torch.Tensor) -> torch.Tensor:
    sh = p["shared"]
    return (F.silu(xt @ sh["wg"]) * (xt @ sh["wu"])) @ sh["wd"]


def _shared_split(cfg, p: dict) -> bool:
    """The shared experts are this rank's tensor-parallel block."""
    return bool(cfg.n_shared_experts) and TP.split(
        p["shared"]["wd"], (cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts,
        0)


def _aux_mean_fn():
    class AuxMean(torch.autograd.Function):
        """The stats' mean over ``axes`` forward; the backward takes 1 /
        ``n_model`` of the gradient (see the module docstring)."""

        @staticmethod
        def forward(ctx, x, axes, n_model):
            ctx.n_model = n_model
            return psum(x.contiguous().clone(), axes) / axis_size(axes)

        @staticmethod
        def backward(ctx, g):
            return g / ctx.n_model, None, None
    return AuxMean


_AUX_MEAN: list = []


def _pmean(aux: dict) -> dict:
    """The aux statistics' mean over ``model`` and the batch axes (one
    collective for all of them)."""
    if not _AUX_MEAN:
        _AUX_MEAN.append(_aux_mean_fn())
    axes = ("model",) + batch_axes()
    stack = torch.stack([v.float().reshape(()) for v in aux.values()])
    vals = _AUX_MEAN[0].apply(stack, axes, axis_size(("model",)))
    return dict(zip(aux, vals))


def capacity(cfg, n_tokens: int, capacity_factor=None) -> int:
    """The per-expert capacity C of a call over ``n_tokens`` tokens."""
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    return max(1, _cdiv(int(n_tokens * cfg.moe_top_k * cf), cfg.n_experts))


def moe_forward(p: dict, cfg, x: torch.Tensor, capacity_factor=None, *,
                with_aux: bool = True):
    """x: (B, S, D) -> ``(out (B, S, D), aux)``, the shared experts added.
    ``aux``: ``moe_balance``, ``moe_z``, ``moe_drop_frac``; empty with
    ``with_aux=False`` (a decode step drops them, as XLA drops the JAX
    package's unused stats). Expert-parallel over ``model`` when the mesh
    in scope has that axis (x and the experts are then the rank's blocks,
    see the module docstring); every expert local otherwise."""
    B, S, D = x.shape
    E = cfg.n_experts
    n = axis_size(("model",)) if "model" in _mesh_axis_names() else 1
    if E % n:
        raise ValueError(f"{E} experts do not shard over {n} model ranks")
    e_local = E // n
    if MOE_DISPATCH == "a2a" and n > 1 and S % n == 0 and S > 1:
        cf = cfg.capacity_factor if capacity_factor is None \
            else capacity_factor
        return _moe_forward_a2a(p, cfg, x, cf, n, e_local, with_aux)
    xt = x.reshape(B * S, D)
    C = capacity(cfg, B * S, capacity_factor)
    if n == 1:
        out, aux = _moe_local(p, cfg, xt, capacity=C, out_dtype=x.dtype,
                              with_aux=with_aux)
        out = out.reshape(B, S, D)
        if cfg.n_shared_experts:
            out = out + _shared(p, xt).reshape(B, S, D)
        return out, aux
    # every model rank routes the same tokens through its own experts
    xe = TP.enter(xt)
    out, aux = _moe_local(p, cfg, xe, capacity=C, out_dtype=x.dtype,
                          with_aux=with_aux,
                          e_offset=flat_index(("model",)) * e_local,
                          e_local=e_local, router=TP.enter(p["router"]))
    split = _shared_split(cfg, p)
    if split:                  # the shared experts' partial sums join them
        out = out + _shared(p, xe)
    # combine the experts' contributions in the activation dtype
    out = TP.leave(out).reshape(B, S, D)
    aux = _pmean(aux) if with_aux else aux
    if cfg.n_shared_experts and not split:
        out = out + _shared(p, xt).reshape(B, S, D)
    return out, aux


def _moe_forward_a2a(p: dict, cfg, x: torch.Tensor, cf, n: int,
                     e_local: int, with_aux: bool):
    """All-to-all token dispatch (``MOE_DISPATCH = 'a2a'``) on this rank's
    S / n span of its (B_local, S, D) block; the spans' outputs gathered
    back over ``model``."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    me = flat_index(("model",))
    Sl = S // n
    xe = TP.enter(x)
    xt = xe[:, me * Sl:(me + 1) * Sl].reshape(B * Sl, D)       # (T_r, D)
    T_r = B * Sl
    # per-destination-rank bucket capacity and per-local-expert capacity
    C = max(1, _cdiv(int(T_r * k), n) * 2)
    C2 = max(1, _cdiv(int(n * C), e_local))
    logits = xt.float() @ TP.enter(p["router"]).float()
    probs, topv, topi = router_topk(logits, k)

    # ---- dispatch into per-destination-rank buckets (choice-major) -----
    slot = _dispatch_positions(topi // e_local, n, C)          # (T_r, k)
    keep = slot < n * C
    src = torch.full((n * C + 1,), T_r, dtype=torch.long, device=x.device)
    src[slot.reshape(-1)] = torch.arange(
        T_r, device=x.device).repeat_interleave(k)
    xt_pad = torch.cat([xt, xt.new_zeros((1, D))])
    buf = xt_pad[src[:n * C]].view(n, C, D)
    ebuf = torch.full((n * C + 1,), -1, dtype=torch.long, device=x.device)
    ebuf[slot.reshape(-1)] = torch.where(keep, topi, -1).reshape(-1)
    ebuf = ebuf[:n * C].view(n, C)

    # ---- ship to the experts' ranks ------------------------------------
    rt = all_to_all_grad(buf, ("model",)).view(n * C, D)
    re = all_to_all(ebuf, ("model",)).view(n * C) - me * e_local

    # ---- local per-expert capacity buffers + FFN ------------------------
    live = (re >= 0) & (re < e_local)
    e2 = torch.where(live, re, e_local)
    experts = torch.arange(e_local, device=x.device)
    cum = torch.cumsum(experts[:, None] == e2[None, :], dim=1,
                       dtype=torch.int32)                      # (e_l, n*C)
    pos2 = torch.gather(cum, 0, e2.clamp(max=e_local - 1)[None, :])[0] - 1
    keep2 = live & (pos2 < C2)
    slot2 = torch.where(keep2, e2 * C2 + pos2, e_local * C2)
    src2 = torch.full((e_local * C2 + 1,), n * C, dtype=torch.long,
                      device=x.device)
    src2[slot2] = torch.arange(n * C, device=x.device)
    rt_pad = torch.cat([rt, rt.new_zeros((1, D))])
    ebuf2 = rt_pad[src2[:e_local * C2]].view(e_local, C2, D)
    h = F.silu(torch.bmm(ebuf2, p["wg"])) * torch.bmm(ebuf2, p["wu"])
    y = torch.bmm(h, p["wd"]).view(e_local * C2, D)
    flat_y = torch.cat([y, y.new_zeros((1, D))])
    yt = torch.where(keep2[:, None], flat_y[slot2], 0.0)       # (n*C, D)

    # ---- ship the results back + combine --------------------------------
    yback = all_to_all_grad(yt.view(n, C, D), ("model",)).view(n * C, D)
    yfull = torch.cat([yback, yback.new_zeros((1, D))])
    out = torch.einsum("tkd,tk->td", yfull[slot].float(), topv * keep)
    out = out.to(x.dtype)
    split = _shared_split(cfg, p)
    if cfg.n_shared_experts and not split:
        sh = {"shared": tree_map(TP.enter, p["shared"])}
        out = out + _shared(sh, xt)
    # the spans back into the (B, S, D) block, replicated over 'model'
    spans = gather_split(out.view(1, B, Sl, D), ("model",))
    out = spans.permute(1, 0, 2, 3).reshape(B, S, D)
    if split:                  # tensor-parallel shared experts, all tokens
        out = out + TP.leave(_shared(p, xe.reshape(B * S, D))).reshape(
            B, S, D)
    aux = _pmean(_aux(probs, topi, logits, E, keep)) if with_aux else {}
    return out, aux


def _moe_param_specs(cfg):
    """The experts over ``model``; the router and the shared experts
    replicated."""
    from repro_torch.sharding.partition import P
    specs = {
        "router": P(None, None),
        "wg": P("model", None, None),
        "wu": P("model", None, None),
        "wd": P("model", None, None),
    }
    if cfg.n_shared_experts:
        specs["shared"] = {"wg": P(None, None), "wu": P(None, None),
                           "wd": P(None, None)}
    return specs


def moe_aux_total(cfg, aux: dict) -> torch.Tensor:
    return (cfg.router_aux_weight * aux["moe_balance"]
            + cfg.router_z_weight * aux["moe_z"])
