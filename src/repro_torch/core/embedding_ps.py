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
trainer donates them, so no caller sees the difference). Every sparse
apply runs through the ``fused_backward`` kernel (its plain version on the
CPU). The embedding-PS shards (``emb_shards``) are the router of
``core/backend.py``.

Under a mesh (``utils.set_mesh``) the table is sharded as the JAX
package's ``shard_map`` paths shard it, and each rank passes its blocks:
its rows of the table (``table_spec``), its block of the ids and grads (a
batch sharded over the batch axes). Two modes:

* ``mode='model'`` (LM vocab tables): rows over the ``model`` axis,
  replicated over the batch axes. Lookup: each model rank reads its own
  rows, a sum over ``model`` combines them. Put: each rank's dense delta
  and count of its own rows, summed over the batch axes (every replica
  applies the same delta, ``_apply_delta``).
* ``mode='full'`` (the paper's CTR tables): rows over every axis. Lookup:
  the ids are gathered over the batch axes, each rank reads its own rows,
  a sum over every axis combines them, and each rank slices its tokens
  back out. Put: each rank's deduplicated put is gathered over the batch
  axes, deduplicated once more on the physical rows, and each rank
  applies its own rows (one ``fused_backward`` launch: the sums of the
  second dedup and the apply).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels import ops as K
from repro_torch.utils import (_mesh_axis_names, all_gather, axis_size,
                               flat_index, psum, round_up)

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


def _axes_for(mode: str) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(shard_axes, batch_axes) present in the mesh in scope."""
    names = _mesh_axis_names()
    batch = tuple(a for a in ("pod", "data") if a in names)
    if mode == "model":
        shard_axes = ("model",) if "model" in names else ()
    else:
        shard_axes = tuple(a for a in ("pod", "data", "model") if a in names)
    return shard_axes, batch


def n_shards(spec: EmbeddingSpec) -> int:
    """The ranks the table's rows are sharded over in the mesh in scope (1
    without a mesh)."""
    return axis_size(_axes_for(spec.mode)[0])


def table_spec(spec: EmbeddingSpec):
    """The table's partition spec: rows over ``model`` or over every
    axis."""
    from repro_torch.sharding.partition import P
    if spec.mode == "model":
        return P("model", None)
    return P(("pod", "data", "model"), None)


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
    shard_axes, batch_axes = _axes_for(spec.mode)
    n = axis_size(shard_axes)
    valid = (flat >= 0) & (flat < spec.rows)
    pos = shuffle_pos(torch.where(valid, flat, 0), spec.padded_rows(n))
    if n == 1:
        out = torch.where(valid[:, None], state["table"][pos], 0)
        return out.reshape(*shape, spec.dim)
    out = _lookup_sharded(state["table"], spec, torch.where(valid, pos, -1),
                          shard_axes, batch_axes, spec.padded_rows(n) // n)
    return out.reshape(*shape, spec.dim)


def _lookup_sharded(table: torch.Tensor, spec: EmbeddingSpec,
                    pos: torch.Tensor, shard_axes, batch_axes,
                    rows_local: int) -> torch.Tensor:
    """The mesh lookup of this rank's (T,) shuffled rows (-1 = padding)
    from its (rows_local, D) block of the table: every id gathered over
    the batch axes (full mode), each rank's own rows read (zeros
    elsewhere), the sum over the shard axes, this rank's T rows kept.
    Each row is one rank's value plus zeros, so it is exact."""
    full = spec.mode != "model"
    pos_all = all_gather(pos, batch_axes) if full else pos
    mine = (pos_all >= 0) & (pos_all // rows_local == flat_index(shard_axes))
    local = torch.where(mine, pos_all % rows_local, 0)
    vals = torch.where(mine[:, None], table[local], 0).contiguous()
    psum(vals, shard_axes)
    if full and batch_axes:
        t = int(pos.shape[0])
        vals = vals[flat_index(batch_axes) * t:][:t]
    return vals


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
    shard_axes, batch_axes = _axes_for(spec.mode)
    if axis_size(shard_axes) > 1:
        return _put_sharded(state, spec, ids, grads, assume_unique,
                            shard_axes, batch_axes)
    rows = spec.padded_rows(1)
    flat = ids.reshape(-1)
    grads = grads.reshape(-1, spec.dim)
    if axis_size(batch_axes) > 1:
        # a table the mesh replicates: every rank applies the whole put
        flat = all_gather(flat.contiguous(), batch_axes)
        grads = all_gather(grads.contiguous(), batch_axes)
        assume_unique = False
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


def _put_sharded(state: dict, spec: EmbeddingSpec, ids: torch.Tensor,
                 grads: torch.Tensor, assume_unique: bool, shard_axes,
                 batch_axes) -> dict:
    """The mesh put of this rank's block of (ids, grads) into its block of
    the table, in place (see the module docstring for the two modes)."""
    from repro_torch.core import compression as C
    from repro_torch.core.dedup import dedup_cap
    n = axis_size(shard_axes)
    rows = spec.padded_rows(n)
    rows_local = rows // n
    me = flat_index(shard_axes)
    flat = ids.reshape(-1)
    valid = (flat >= 0) & (flat < spec.rows)
    pos = shuffle_pos(torch.where(valid, flat, 0), rows)
    pos_signed = torch.where(valid, pos, -1)
    g = torch.where(valid[:, None], grads.reshape(-1, spec.dim).float(), 0.0)
    if spec.mode == "model":
        # a dense delta of this rank's rows aggregates duplicates exactly
        # without a sort; the extra row rows_local takes the others' ids
        owner = torch.where(pos_signed >= 0, pos_signed // rows_local, -1)
        local = torch.where(owner == me, pos_signed % rows_local, rows_local)
        f32 = dict(dtype=torch.float32, device=g.device)
        delta = torch.zeros((rows_local + 1, spec.dim), **f32).index_add_(
            0, local, g)[:rows_local]
        cnt = torch.zeros((rows_local + 1,), **f32).index_add_(
            0, local, (owner == me).float())[:rows_local]
        psum(delta, batch_axes)
        psum(cnt, batch_axes)
        return _apply_delta(state, spec, delta, cnt)
    # the deduplicated put is what crosses the wire: gathered over the
    # batch shards, where a row can arrive from several of them, so it is
    # aggregated once more before each rank applies its own rows
    if assume_unique:
        pos_u, g_u = pos_signed, g
    else:
        pos_u, g_u = C.dedup_put(pos_signed, g,
                                 dedup_cap(int(flat.numel()), rows))
    uniq_all = all_gather(pos_u.to(torch.int32), batch_axes)
    g_all = all_gather(g_u.contiguous(), batch_axes)
    return apply_gathered(state, spec, uniq_all, g_all)


def apply_gathered(state: dict, spec: EmbeddingSpec, pos_all: torch.Tensor,
                   g_all: torch.Tensor) -> dict:
    """The full-mode mesh put's second half, in place: a put gathered over
    the batch axes (physical rows, -1 for padding; fp32 rows) deduplicated
    once more on the rows and applied where this rank holds them, the
    sums and the apply in one ``fused_backward`` launch."""
    from repro_torch.core import compression as C
    shard_axes, _ = _axes_for(spec.mode)
    n = axis_size(shard_axes)
    rows = spec.padded_rows(n)
    rows_local = rows // n
    plan = C.dedup_plan(pos_all, min(int(pos_all.shape[0]), rows))
    mine = (plan.dev >= 0) & (plan.dev // rows_local == flat_index(shard_axes))
    fused_apply(state, spec, plan.order, plan.offsets, g_all,
                torch.where(mine, plan.dev % rows_local, -1), None)
    return state


def _apply_delta(st: dict, spec: EmbeddingSpec, delta: torch.Tensor,
                 cnt: torch.Tensor) -> dict:
    """PS-shard-local optimizer step given a dense per-shard delta
    (model-mode tables: V_local x D is small), in place. ``cnt`` (the puts
    a row received) is carried as in the JAX package, which does not read
    it either."""
    if spec.optimizer == "adagrad":
        acc = st["acc"].add_(torch.mean(torch.square(delta), dim=-1))
        step = delta * torch.rsqrt(acc + spec.eps)[:, None]
    else:
        step = delta
    table = st["table"]
    table.copy_((table.float() - spec.lr * step).to(table.dtype))
    return st


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
