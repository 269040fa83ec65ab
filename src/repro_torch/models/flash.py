"""Flash attention forward over the grouped-GQA layout (port of the
forward of ``repro/models/flash.py::flash_attention``).

The models keep q as (B, Sq, Hkv, G, Dh) and k, v as (B, Sk, Hkv, Dh); the
``flash_attention_fwd`` kernel takes (B, Hq, S, Dh) with query head
``h = hkv * G + g``. This module converts between the two (contiguous
copies) and calls ``kernels.ops.flash_attention_fwd``: the CUDA kernel on
the card, its plain version on the CPU. No padding: the kernel masks its
ragged tiles itself. The JAX package's jnp backward (recompute from the
saved logsumexp) waits for LM training.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def to_kernel_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(B, Sq, Hkv, G, Dh), (B, Sk, Hkv, Dh) x2 -> (B, Hkv * G, Sq, Dh),
    (B, Hkv, Sk, Dh) x2, contiguous."""
    B, Sq, Hkv, G, Dh = q.shape
    qk = q.permute(0, 2, 3, 1, 4).reshape(B, Hkv * G, Sq, Dh).contiguous()
    return (qk, k.permute(0, 2, 1, 3).contiguous(),
            v.permute(0, 2, 1, 3).contiguous())


def from_kernel_layout(o: torch.Tensor, q_shape) -> torch.Tensor:
    """(B, Hkv * G, Sq, Dv) -> (B, Sq, Hkv, G, Dv)."""
    B, Sq, Hkv, G, _ = q_shape
    return o.reshape(B, Hkv, G, Sq, -1).permute(0, 3, 1, 2, 4)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, Hkv, G, Dh); k: (B, Sk, Hkv, Dh); v: (B, Sk, Hkv, Dh) ->
    (B, Sq, Hkv, G, Dh) in q's dtype."""
    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError("a value head dim other than the query's "
                                  "is not ported yet")
    o, _ = ops.flash_attention_fwd(*to_kernel_layout(q, k, v), scale,
                                   causal, window, q_offset)
    return from_kernel_layout(o, q.shape)
