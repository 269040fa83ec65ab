"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) mixer (port of
``repro/models/mamba2.py``).

Training and prefill take the chunked SSD decomposition: within a chunk of
``ssm_chunk`` positions the terms are quadratic (L x L), across chunks the
state (B, H, N, P) is carried by a Python loop over the chunks, as the JAX
package's ``lax.scan`` carries it, so one chunk's (B, L, L, H) tensors are
alive at a time. Decode is the O(1) recurrence h <- h exp(dt A) + dt B x.
Plain torch einsums: the JAX module reaches no Pallas kernel.

One repair against the JAX package: the intra-chunk decay is
``exp(seg)`` masked to the lower triangle. The JAX package takes ``exp`` of
every entry and then selects; above the diagonal ``seg`` is a positive sum
of ``-dt A`` over up to ``ssm_chunk`` positions, which overflows to inf at
the published chunk of 256, and the select's gradient multiplies 0 by inf
(NaN gradients in ``in_proj``, ``A_log`` and ``dt_bias``). Here ``seg`` is
set to -inf above the diagonal before the ``exp``: the same forward, finite
gradients.

Parameters keep the JAX package's tree and key names (``in_proj``,
``conv_w``, ``conv_b``, ``A_log``, ``dt_bias``, ``D``, ``out_norm``,
``out_proj``); ``lead`` puts the transformer's stack axis in front. A
cache is ``{"h": (B, H, N, P) fp32, "conv": (B, K - 1, conv channels)}``;
:func:`mamba2_decode` updates it in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    P_ = cfg.ssm_head_dim
    H = d_inner // P_
    N = cfg.ssm_state
    return d_inner, H, P_, N


def mamba2_init(generator: torch.Generator, cfg, dtype=torch.float32, *,
                lead: tuple = (), device=None) -> dict:
    """The JAX package's draws (N(0, 1) times its scales, ``dt_bias`` the
    inverse softplus of a log-uniform draw in [1e-3, 1e-1]); other numbers
    (``jax.random`` streams cannot be reproduced)."""
    d = cfg.d_model
    d_inner, H, P_, N = ssm_dims(cfg)
    conv_ch = d_inner + 2 * N                    # x, B, C go through the conv
    device = generator.device if device is None else device
    kw = dict(lead=lead, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((*lead, cfg.ssm_conv_width, conv_ch),
                         generator=generator, **f32).mul_(0.2)
    u = torch.rand((*lead, H), generator=generator, **f32)
    dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    a_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    return {
        "in_proj": dense_init(generator, d, 2 * d_inner + 2 * N + H, dtype,
                              **kw),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dtype, device=device),
        "A_log": a_log.expand(*lead, H).clone(),
        "dt_bias": torch.log(torch.expm1(dt)),
        "D": torch.ones((*lead, H), **f32),
        "out_norm": {"w": torch.ones((*lead, d_inner), **f32)},
        "out_proj": dense_init(generator, d_inner, d, dtype,
                               scale=1.0 / math.sqrt(d_inner), **kw),
    }


def _split_proj(cfg, proj: torch.Tensor):
    """in_proj's output -> (z, xbc, dt)."""
    d_inner, H, _, N = ssm_dims(cfg)
    return torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv of width K, then SiLU. xbc: (B, S, C); w: (K,
    C)."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return F.silu(out + b)


def _gated_out(p: dict, cfg, y: torch.Tensor, z: torch.Tensor, x_dtype):
    """y * silu(z), an RMSNorm over d_inner in fp32, then ``out_proj``."""
    y = y * F.silu(z.to(y.dtype))
    y32 = y.float()
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + cfg.norm_eps)
         * p["out_norm"]["w"]).to(x_dtype)
    return y @ p["out_proj"]


def mamba2_forward(p: dict, cfg, x: torch.Tensor, *, return_state=False):
    """Chunked SSD over the full sequence. x: (B, S, D) -> (B, S, D); with
    ``return_state`` also the decode cache ``{"h", "conv"}`` after the last
    position. A sequence that is not a chunk multiple is padded with dt = 0,
    which leaves the outputs and the carried state exactly as they are."""
    B, S0, _ = x.shape
    d_inner, H, P_, N = ssm_dims(cfg)
    L = min(cfg.ssm_chunk, S0)
    z, xbc, dt_raw = _split_proj(cfg, x @ p["in_proj"])
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    pad = (-S0) % L
    S = S0 + pad
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                # (B,S0,H)
    if pad:
        xbc = F.pad(xbc, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))                 # dt = 0 on the pad
    nC = S // L
    xs, Bmat, Cmat = torch.split(xbc, [d_inner, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P_)
    A = -torch.exp(p["A_log"])                                     # (H,)
    dA = dt * A                                                    # <= 0

    xs_c = xs.reshape(B, nC, L, H, P_).float()
    B_c = Bmat.reshape(B, nC, L, N).float()
    C_c = Cmat.reshape(B, nC, L, N).float()
    dt_c = dt.reshape(B, nC, L, H)
    dA_c = dA.reshape(B, nC, L, H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    above = ~tri[None, :, :, None]

    h = x.new_zeros((B, H, N, P_), dtype=torch.float32)
    ys = []
    for c in range(nC):
        x_i, b_i, c_i = xs_c[:, c], B_c[:, c], C_c[:, c]
        dt_i, dA_i = dt_c[:, c], dA_c[:, c]
        cum = torch.cumsum(dA_i, dim=1)                            # (B,L,H)
        # intra-chunk: decay[i, j] = exp(cum_i - cum_j) for i >= j; the
        # upper triangle is masked BEFORE the exp (see the module doc)
        seg = cum[:, :, None, :] - cum[:, None, :, :]              # (B,L,L,H)
        decay = torch.exp(seg.masked_fill(above, float("-inf")))
        del seg
        cb = torch.einsum("bln,bmn->blm", c_i, b_i)                # (B,L,L)
        xdt = x_i * dt_i[..., None]                                # (B,L,H,P)
        y_diag = torch.einsum("blmh,bmhp->blhp", cb[..., None] * decay, xdt)
        del decay
        # inter-chunk, from the carried state
        y_off = torch.einsum("bln,blh,bhnp->blhp", c_i, torch.exp(cum), h)
        # state update
        last = cum[:, -1:, :]                                      # (B,1,H)
        w_state = torch.exp(last - cum) * dt_i                     # (B,L,H)
        s_i = torch.einsum("bln,blh,blhp->bhnp", b_i, w_state, x_i)
        h = h * torch.exp(last[:, 0])[:, :, None, None] + s_i
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P_)
    y = y + xs.float() * p["D"][:, None]
    y = y[:, :S0].reshape(B, S0, d_inner)
    out = _gated_out(p, cfg, y, z, x.dtype)
    if return_state:
        return out, {"h": h, "conv": _conv_tail(cfg, x, p)}
    return out


def _conv_tail(cfg, x: torch.Tensor, p: dict) -> torch.Tensor:
    """The last K - 1 positions' conv inputs (before the conv), left-padded
    with zeros where the sequence is shorter: (B, K - 1, conv channels)."""
    K = cfg.ssm_conv_width
    _, xbc, _ = _split_proj(cfg, x[:, -(K - 1):] @ p["in_proj"])
    short = (K - 1) - xbc.shape[1]
    if short > 0:
        xbc = F.pad(xbc, (0, 0, short, 0))
    return xbc


def mamba2_decode(p: dict, cfg, x: torch.Tensor, cache: dict):
    """One-token recurrent step. x: (B, 1, D); cache ``{"h": (B, H, N, P)
    fp32, "conv": (B, K - 1, conv channels)}``, updated in place. Returns
    ``(out (B, 1, D), cache)``."""
    B = x.shape[0]
    d_inner, H, P_, N = ssm_dims(cfg)
    z, xbc_new, dt_raw = _split_proj(cfg, x @ p["in_proj"])        # (B,1,*)
    window = torch.cat([cache["conv"], xbc_new.to(cache["conv"].dtype)],
                       dim=1)                                      # (B,K,C)
    conv = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv = F.silu(conv)[:, None, :]                                # (B,1,C)
    xs, Bm, Cm = torch.split(conv, [d_inner, N, N], dim=-1)
    xs = xs.reshape(B, H, P_).float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])           # (B,H)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))
    bx = torch.einsum("bn,bhp->bhnp", Bm[:, 0].float(), xs * dt[..., None])
    h = cache["h"] * dA[:, :, None, None] + bx                     # (B,H,N,P)
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), h)
    y = y + xs * p["D"][None, :, None]
    out = _gated_out(p, cfg, y.reshape(B, 1, d_inner), z, x.dtype)
    cache["h"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    return out, cache


def mamba2_cache_init(cfg, batch: int, dtype=torch.float32, *,
                      lead: tuple = (), device=None) -> dict:
    d_inner, H, P_, N = ssm_dims(cfg)
    conv_ch = d_inner + 2 * N
    return {"h": torch.zeros((*lead, batch, H, N, P_), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((*lead, batch, cfg.ssm_conv_width - 1,
                                 conv_ch), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# The step-by-step recurrence: the oracle of the tests
# ---------------------------------------------------------------------------

def mamba2_reference_scan(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """The O(S) recurrence one position at a time; equal to the chunked
    path up to rounding."""
    B, S, _ = x.shape
    d_inner, H, P_, N = ssm_dims(cfg)
    z, xbc, dt_raw = _split_proj(cfg, x @ p["in_proj"])
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, Bmat, Cmat = torch.split(xbc, [d_inner, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P_).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h = x.new_zeros((B, H, N, P_), dtype=torch.float32)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A)                               # (B,H)
        bx = torch.einsum("bn,bhp->bhnp", Bmat[:, t].float(),
                          xs[:, t] * dt[:, t][..., None])
        h = h * dA[:, :, None, None] + bx
        ys.append(torch.einsum("bn,bhnp->bhp", Cmat[:, t].float(), h))
    y = torch.stack(ys, dim=1) + xs * p["D"][:, None]
    return _gated_out(p, cfg, y.reshape(B, S, d_inner), z, x.dtype)
