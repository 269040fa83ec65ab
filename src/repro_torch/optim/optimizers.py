"""Dense-side optimizers (the NN worker's Omega^nn in Alg. 2), written out
by hand (port of ``repro/optim/optimizers.py``; not ``torch.optim``).

Parameters, gradients and moments are nested dict/list trees of tensors in
the JAX package's layout, so optimizer states interchange through the
checkpoint format: ``{"m", "v", "t"}`` for Adam, ``{"t"}`` (plus ``"m"``
with momentum) for SGD. ``t`` is a Python int here: the step count drives
host-side arithmetic only (the bias corrections), so keeping it on the host
spares a device round trip per step. Updates write the parameters and
moments in place, leaf by leaf, and return the same trees (the JAX
trainer donates them; an LM's 2.5 B parameters would not fit a second
copy of parameters and moments next to the first on one card). The
arithmetic follows the JAX package's operation for operation, so the two
agree to the last few bits of fp32 (XLA and torch pick different roundings
for ``rsqrt`` and ``pow``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.utils import tree_leaves, tree_map


def _zeros_like_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


# -- SGD (+momentum) ---------------------------------------------------------

def sgd_init(params, momentum=0.0):
    if momentum:
        return {"m": _zeros_like_f32(params), "t": 0}
    return {"t": 0}


def sgd_update(params, grads, state, *, lr, momentum=0.0, weight_decay=0.0):
    """One SGD step, in place (see the module doc)."""
    t = int(state["t"]) + 1

    def step_of(p, g, m=None):
        g32 = g.float()
        if weight_decay:
            g32 = g32 + weight_decay * p.float()
        return g32 if m is None else momentum * m + g32

    def upd(p, g, m=None):
        s = step_of(p, g, m)
        if m is not None:
            m.copy_(s)
        p.copy_(p.float() - lr * s)

    if momentum:
        tree_map(upd, params, grads, state["m"])
        return params, {"m": state["m"], "t": t}
    tree_map(upd, params, grads)
    return params, {"t": t}


# -- Adam ---------------------------------------------------------------------

def adam_init(params):
    return {"m": _zeros_like_f32(params), "v": _zeros_like_f32(params),
            "t": 0}


def adam_update(params, grads, state, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=0.0, grad_clip=0.0):
    """One Adam step, in place (see the module doc)."""
    t = int(state["t"]) + 1
    scale = None
    if grad_clip > 0:
        gn = global_norm(grads)
        scale = torch.clamp(torch.full_like(gn, grad_clip)
                            / torch.clamp(gn, min=1e-9), max=1.0)
    # the bias corrections in fp32, as the JAX package computes them; one
    # (2,) upload, so the divisions below are tensor divisions on every
    # device (CUDA turns a division by a host scalar into a product with
    # its reciprocal, which rounds differently)
    f32 = np.float32
    bc = np.array([f32(1.0) - np.power(f32(b1), f32(t)),
                   f32(1.0) - np.power(f32(b2), f32(t))], np.float32)
    leaves = tree_leaves(params)
    bc = torch.from_numpy(bc).to(leaves[0].device if leaves else "cpu")
    bc1, bc2 = bc[0], bc[1]

    def upd(p, g, m, v):
        g32 = (g if scale is None else g * scale).float()
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * (g32 * g32))
        step = (m / bc1) * torch.rsqrt(v / bc2 + eps * eps)
        # rsqrt(x + eps^2) ~ 1/(sqrt(x)+eps); cheaper and stable
        if weight_decay:
            step = step + weight_decay * p.float()
        p.copy_(p.float() - lr * step)

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "t": t}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


# -- LR schedules --------------------------------------------------------------

def linear_warmup_cosine(step, *, base_lr, warmup, total) -> torch.Tensor:
    """fp32 learning rate at ``step`` (an int or a 0-dim tensor), returned
    as a 0-dim fp32 CPU tensor: a host scalar to every device."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)


# -- Factory --------------------------------------------------------------------

@dataclass(frozen=True)
class OptConfig:
    kind: str = "adam"
    lr: float = 3e-4
    momentum: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0


def make_optimizer(cfg: OptConfig):
    """``(init, update)`` with ``update(params, grads, state, lr=None) ->
    (params, state)``; ``lr=None`` takes ``cfg.lr``."""
    if cfg.kind == "adam":
        def update(params, grads, state, lr=None):
            return adam_update(params, grads, state,
                               lr=cfg.lr if lr is None else lr,
                               b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                               weight_decay=cfg.weight_decay,
                               grad_clip=cfg.grad_clip)
        return adam_init, update
    if cfg.kind == "sgd":
        def init(params):
            return sgd_init(params, cfg.momentum)

        def update(params, grads, state, lr=None):
            return sgd_update(params, grads, state,
                              lr=cfg.lr if lr is None else lr,
                              momentum=cfg.momentum,
                              weight_decay=cfg.weight_decay)
        return init, update
    raise ValueError(f"unknown optimizer kind {cfg.kind!r}: 'adam' or 'sgd'")
