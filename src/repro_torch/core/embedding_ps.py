"""Embedding PS math for one shard (port of ``repro/core/embedding_ps.py``):
the table spec, the paper's uniform-shuffle row placement (§4.2.3), the
table init and the lookup.

Row placement: a fixed affine hash permutes row ids, so hot feature groups
spread evenly when rows are later split over PS shards. The physical row
layout is byte-identical to the JAX package's, so a table moves between the
two packages as it is (``repro_torch.convert``). The mesh-sharded lookup
(``shard_map`` branches) and the training updates come with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.utils import round_up

# Affine permutation constants (odd multiplier => bijection mod 2^k when padded)
_SHUFFLE_MULT = 1_000_003
_SHUFFLE_ADD = 12_345
_U32 = 0xFFFF_FFFF


@dataclass(frozen=True)
class EmbeddingSpec:
    rows: int                       # logical rows (vocab size / total id space)
    dim: int
    mode: str = "model"             # 'model' | 'full' (mesh sharding mode)
    optimizer: str = "adagrad"      # 'adagrad' | 'sgd'
    lr: float = 1e-2
    eps: float = 1e-8
    staleness: int = 0              # tau; 0 = synchronous embedding updates
    dtype: Any = torch.float32
    # storage backend (core/backend.py); the port has 'dense' so far
    backend: str = "dense"
    # worker-side batch dedup (core/dedup.py): True (default) reads through
    # a per-batch DedupPlan at unique width (the unique_bag kernel); False
    # reads at occurrence width (the embedding_bag kernel)
    batch_dedup: bool = True

    def padded_rows(self, n_shards: int) -> int:
        return round_up(self.rows, max(n_shards, 1))


def shuffle_pos(ids: torch.Tensor, padded_rows: int) -> torch.Tensor:
    """Uniform-shuffle storage position for a row id (int64). The JAX
    package multiplies in uint32, so the product wraps mod 2^32; int64
    arithmetic masked to 32 bits gives the same positions bit for bit."""
    u = ids.long() & _U32
    return ((u * _SHUFFLE_MULT + _SHUFFLE_ADD) & _U32) % padded_rows


def ps_init(generator: torch.Generator, spec: EmbeddingSpec,
            n_shards: int = 1, scale: float = 0.02) -> dict:
    """Embedding PS state: table + row-wise optimizer accumulator, on the
    generator's device."""
    rows = spec.padded_rows(n_shards)
    table = (torch.randn((rows, spec.dim), generator=generator,
                         device=generator.device, dtype=torch.float32)
             * scale).to(spec.dtype)
    state = {"table": table}
    if spec.optimizer == "adagrad":
        state["acc"] = torch.zeros((rows,), dtype=torch.float32,
                                   device=generator.device)
    return state


def lookup(state: dict, spec: EmbeddingSpec, ids: torch.Tensor
           ) -> torch.Tensor:
    """ids: (...,) integer -> (..., dim). Out-of-range ids (< 0 or >=
    rows) return zeros (used as padding in multi-hot bags)."""
    shape = ids.shape
    flat = ids.reshape(-1)
    valid = (flat >= 0) & (flat < spec.rows)
    pos = shuffle_pos(torch.where(valid, flat, 0), spec.padded_rows(1))
    out = torch.where(valid[:, None], state["table"][pos], 0)
    return out.reshape(*shape, spec.dim)
