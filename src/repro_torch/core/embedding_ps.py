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
trainer donates them, so no caller sees the difference). Every apply runs
through the ``fused_backward`` kernel (its plain version on the CPU). The
mesh-sharded branches (``shard_map``) come with a later slice; the
embedding-PS shards (``emb_shards``) are the router of ``core/backend.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels import ops as K
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
    # storage backend (core/backend.py): 'dense' | 'host_lru' |
    # 'host_lru+disk', optionally behind the '+compressed' wire. 'dense' is
    # the device-resident PS shard; 'host_lru' keeps `rows` host-side
    # behind a device hot-cache of `cache_rows` slots (paper §4.2.2
    # out-of-core tier); '+disk' stacks a memory-mapped disk tier under a
    # host LRU of `host_rows` (core/mmap_store.py)
    backend: str = "dense"
    cache_rows: int = 0             # host_lru: device-resident hot slots
    wire_block: int = 128           # +compressed: blockscale block size
    # +compressed: in the JAX package, the Pallas kernel instead of the jnp
    # codec (equal outputs). It selects nothing in the port, whose wire
    # always runs the CUDA codec (ops.blockscale_*); kept so specs and
    # checkpoints round-trip, and True still needs wire_block == 128
    wire_kernel: bool = False
    # in the JAX package, the Pallas fused backward instead of its jnp
    # oracle (kernels/fused_backward.py). It selects nothing in the port,
    # whose puts always run the fused_backward CUDA kernel
    # (ops.fused_backward); kept so specs and collections round-trip
    backward_kernel: bool = False
    # host-store row format (core/lru.py, core/mmap_store.py): 'fp32' or
    # 'blockscale16' (fp16 payload + one fp32 scale per <=128-wide block:
    # the wire codec applied at rest, in numpy on the host). Rows are
    # decompressed on fault-in and recompressed on write-back, so the
    # device cache and the optimizer math stay fp32. host_lru only
    store_dtype: str = "fp32"
    # frequency-aware admission (core/hotness.py): > 0 serves a faulting
    # id whose decayed count-min hotness is below the threshold from
    # `bypass_rows` scratch slots instead of a main cache slot; 0 =
    # recency-only admission
    admit_threshold: float = 0.0
    bypass_rows: int = 0            # scratch slots (0 = cache_rows // 4)
    # '+disk' tier sizing (core/mmap_store.py)
    host_rows: int = 0              # host LRU tier rows (0 = rows // 4)
    disk_path: str | None = None    # mmap backing dir (None = tempdir)
    # sharded PS router (core/backend.py ShardedBackend): the number of
    # independent embedding-PS shards the table is hash-partitioned over
    # (paper §4.1). 1 = the plain backend; k > 1 routes ids over k
    # per-shard backends with their own stores, locks and queues
    emb_shards: int = 1
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

    ``assume_unique=True`` declares the put pre-deduplicated (a dedup
    plan's unique ids with their segment-summed grads). Otherwise the put
    is first aggregated on the PHYSICAL rows (``compression.dedup_plan``,
    the grouping of ``dedup_put``): two logical ids that share a shuffled
    row are summed into one row here, before the accumulator sees them, as
    in the JAX package. The aggregation's sums and the apply are one
    ``fused_backward`` launch."""
    from repro_torch.core import compression as C
    from repro_torch.core.dedup import dedup_cap
    rows = spec.padded_rows(1)
    flat = ids.reshape(-1)
    grads = grads.reshape(-1, spec.dim)
    valid = (flat >= 0) & (flat < spec.rows)
    pos = shuffle_pos(torch.where(valid, flat, 0), rows)
    pos_signed = torch.where(valid, pos, -1)
    if assume_unique:
        return _apply_sparse(state, spec, pos_signed,
                             torch.where(valid[:, None], grads.float(), 0.0))
    plan = C.dedup_plan(pos_signed, dedup_cap(int(flat.numel()), rows))
    fused_apply(state, spec, plan.order, plan.offsets,
                grads.float().contiguous(), plan.dev, None)
    return state


def fused_apply(st: dict, spec: EmbeddingSpec, order, offsets, grads,
                idx: torch.Tensor, g) -> torch.Tensor:
    """One ``fused_backward`` launch on ``st``: the segment sums of
    ``grads`` along (order, offsets), then the row-wise optimizer step at
    ``idx`` (-1 = no-op) with ``g``, or with the sums when ``g`` is None.
    Returns the sums."""
    acc = st.get("acc") if spec.optimizer == "adagrad" else None
    return K.fused_backward(st["table"], acc, order, offsets, grads,
                            idx.to(torch.int32).contiguous(), g, lr=spec.lr,
                            eps=spec.eps, apply_self=g is None)


def _apply_sparse(st: dict, spec: EmbeddingSpec, idx: torch.Tensor,
                  g: torch.Tensor) -> dict:
    """Row-sparse optimizer apply, in place: O(#puts), never O(rows).
    idx: (U,) row indices, -1 = no-op. Duplicate rows accumulate (the
    paper's lock-free put: acc sees every increment before the scaled step
    is taken). One ``fused_backward`` launch with no segment to sum."""
    i32 = dict(dtype=torch.int32, device=g.device)
    fused_apply(st, spec, torch.zeros(0, **i32), torch.zeros(1, **i32),
                g.new_zeros((0, spec.dim)), idx, g.float().contiguous())
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
    (sync). ``assume_unique`` passes to :func:`apply_put`: without it the
    queue holds the put at occurrence width and the popped put is
    aggregated when it is applied."""
    if spec.staleness <= 0 or queue is None:
        return apply_put(state, spec, ids, grads, assume_unique), queue
    queue, old_ids, old_grads = queue_push_pop(queue, ids, grads)
    state = apply_put(state, spec, old_ids, old_grads, assume_unique)
    return state, queue
