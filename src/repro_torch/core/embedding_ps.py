"""Embedding PS math for one shard (port of ``repro/core/embedding_ps.py``):
the table spec, the paper's uniform-shuffle row placement (§4.2.3), the
table init, the lookup, the row-sparse optimizer apply and the bounded-
staleness queue of pending puts (Alg. 1).

Row placement: a fixed affine hash permutes row ids, so hot feature groups
spread evenly when rows are later split over PS shards. The physical row
layout is byte-identical to the JAX package's, so a table moves between the
two packages as it is (``repro_torch.convert``). The hash wraps mod 2^32,
so above 4,294 rows it is not a bijection: two logical ids can share a
physical row (at 62,500 rows a quarter of the rows are shared), and a put
of unique ids can name one row twice. The apply handles that as the JAX
package does (both increments reach the accumulator first).

Unlike the JAX package, whose arrays are immutable, the puts and the queue
update the state's tensors in place and return the same dicts (the JAX
trainer donates them, so no caller sees the difference). The mesh-sharded
branches (``shard_map``) and the put of non-unique ids (``dedup_put``) come
with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels import ref as KR
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


# ---------------------------------------------------------------------------
# Gradient put + optimizer apply (Persia Alg.1 backward)
# ---------------------------------------------------------------------------

def apply_put(state: dict, spec: EmbeddingSpec, ids: torch.Tensor,
              grads: torch.Tensor, assume_unique: bool = False) -> dict:
    """Apply activation gradients to the table (put + PS-side optimizer),
    in place. ids: (T,) logical ids (< 0 or >= rows = no-op); grads:
    (T, dim) — the gradients of the looked-up activations (F^emb').

    Only the pre-deduplicated put (``assume_unique=True``: a dedup plan's
    unique ids with their segment-summed grads) is ported; the JAX
    package's on-device dedup of repeated ids (``dedup_put``) comes with a
    later slice."""
    if not assume_unique:
        raise NotImplementedError(
            "apply_put of non-unique ids needs dedup_put (core/compression"
            ".py), which the torch port does not have yet: pass a dedup "
            "plan's unique ids with assume_unique=True")
    rows = spec.padded_rows(1)
    flat = ids.reshape(-1)
    grads = grads.reshape(-1, spec.dim)
    valid = (flat >= 0) & (flat < spec.rows)
    pos = shuffle_pos(torch.where(valid, flat, 0), rows)
    g = torch.where(valid[:, None], grads.float(), 0.0)
    return _apply_sparse(state, spec, torch.where(valid, pos, rows), g, rows)


def _apply_sparse(st: dict, spec: EmbeddingSpec, idx: torch.Tensor,
                  g: torch.Tensor, n_rows: int) -> dict:
    """Row-sparse optimizer apply, in place: O(#puts), never O(rows).
    idx: (U,) row indices, entries outside [0, n_rows) dropped. Duplicate
    rows accumulate (the paper's lock-free put: acc sees every increment
    before the scaled step is taken)."""
    acc = st["acc"] if spec.optimizer == "adagrad" else None
    live = (idx >= 0) & (idx < n_rows)
    KR.apply_rows_ref(st["table"], acc, torch.where(live, idx, -1), g,
                      lr=spec.lr, eps=spec.eps)
    return st


# ---------------------------------------------------------------------------
# Bounded-staleness queue (the async relaxation; Assumption 1, t - D(t) <= tau)
# ---------------------------------------------------------------------------

def queue_init(spec: EmbeddingSpec, put_ids_shape, put_dim: int,
               device=None):
    """FIFO of tau pending puts (``None`` for tau = 0). Each slot holds
    (ids, grads); grads in the table's dtype. ``ptr`` and ``filled`` are
    host ints (the JAX package keeps int32 scalars on the device; the
    checkpoint stores them as int32)."""
    tau = spec.staleness
    if tau <= 0:
        return None
    return {
        "ids": torch.full((tau,) + tuple(put_ids_shape), -1,
                          dtype=torch.int32, device=device),
        "grads": torch.zeros((tau,) + tuple(put_ids_shape) + (put_dim,),
                             dtype=spec.dtype, device=device),
        "ptr": 0,
        "filled": 0,
    }


def queue_push_pop(queue: dict, ids: torch.Tensor, grads: torch.Tensor):
    """Push this step's put into the slot at ``ptr``; pop the put it held,
    from tau steps ago (ids = -1 during warmup: a no-op put). Returns
    ``(queue, old_ids, old_grads)``; the popped arrays are copies."""
    ptr = int(queue["ptr"])
    old_ids = queue["ids"][ptr].clone()
    old_grads = queue["grads"][ptr].clone()
    queue["ids"][ptr] = ids.to(torch.int32)
    queue["grads"][ptr] = grads.to(queue["grads"].dtype)
    tau = queue["ids"].shape[0]
    return dict(queue, ptr=(ptr + 1) % tau,
                filled=min(int(queue["filled"]) + 1, tau)), old_ids, \
        old_grads


def hybrid_emb_update(state: dict, queue, spec: EmbeddingSpec,
                      ids: torch.Tensor, grads: torch.Tensor,
                      assume_unique: bool = False):
    """One hybrid-algorithm embedding update: enqueue this step's put,
    apply the (tau-stale) put that pops out. tau=0 applies immediately
    (sync). ``assume_unique`` passes to :func:`apply_put`, which takes only
    unique ids in the port."""
    if spec.staleness <= 0 or queue is None:
        return apply_put(state, spec, ids, grads, assume_unique), queue
    queue, old_ids, old_grads = queue_push_pop(queue, ids, grads)
    state = apply_put(state, spec, old_ids, old_grads, assume_unique)
    return state, queue
