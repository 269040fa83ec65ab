"""Embedding storage backends (port of ``repro/core/backend.py``): the
protocol base, the device-resident ``DenseBackend``, the out-of-core
``HostLRUBackend`` (paper §4.2.2) and the §4.2.3 compressed wire
(``CompressedWireBackend``), with the factory that builds them from
``EmbeddingSpec.backend``.

The serving path reads every table through :func:`read_pooled_all` (the
per-table :meth:`EmbeddingBackend.read_pooled`, grouped), which returns
the sum-pooled bags straight from the CUDA kernels: with
``spec.batch_dedup`` (the default) the host builds a
:class:`~repro_torch.core.dedup.DedupPlan` and ``unique_bag`` gathers,
scatters and pools at unique width; without it ``embedding_bag`` pools at
occurrence width. That is the trainer's own choice between plan and flat
ids in the JAX package (``prepare_all``), applied to the read. Both are
one bag kernel (``embedding_bag`` is its identity case), so every table of
a read pools in ONE launch. A host_lru read is read-only: it gathers its
hits from the device cache and its misses from the host store into one
block of unique rows, which the same launch pools with the identity for
``dev``.

The training path: ``prepare_all`` builds every table's plan on the host
(a host_lru table faults its missing rows into the device cache and writes
its evicted rows back first, and its plan's device ids are cache slots)
and uploads all of the plans' index arrays in one copy; ``lookup_all``
pools every table in ONE bag launch (``unique_bag`` through a plan,
``embedding_bag`` for the occurrence-width ids of ``batch_dedup=False``
tables); ``put_all`` runs each table's put through
the ``fused_backward`` kernel, which segment-sums the occurrence
gradients, applies the row-wise optimizer to the put that pops out of the
staleness queue (or to its own sums in sync mode) and returns the payload
pushed into the queue. A put of occurrence-width ids is grouped on the
device first (``compression.dedup_plan``) and summed by the same kernel.
The puts update the tables, their accumulators and the queues in place
(the JAX trainer donates them). Each backend maps its device ids to table
rows through :meth:`EmbeddingBackend.table_rows` (the uniform shuffle, or
the cache slots themselves), so the fan-outs treat every table alike.

``CompressedWireBackend`` wraps either storage backend: its gets and puts
cross the wire as blockscale fp16 (the ``blockscale_compress`` /
``blockscale_decompress`` CUDA kernels) and its puts are deduplicated to
one row per unique id. The stage's tables compress together and
decompress together: ONE launch of each per get, put or serve read.

``ShardedBackend`` is the sharded embedding-PS router (paper §4.1): a
table with ``spec.emb_shards = k > 1`` is hash-partitioned over k dense
or host_lru shards, each with its own state, lock, store and staleness
queue (state and queues are dicts keyed ``"s0".."s{k-1}"``, the JAX
package's layout, so checkpoints interchange and reshard N -> M). Its
host_lru shards fault in concurrently on a thread pool. The stages keep
one bag launch: a router table's lookup or serve read gathers each
shard's owned unique rows into ONE (U, D) block by index (no arithmetic,
so it is bit-exact with one shard) and pools it with the identity for
``dev``. Its put keeps the JAX package's decomposition: ONE sum-only
``fused_backward`` launch per table, then one apply-only launch per
shard on the shard's local ids with the full sums. The wire wraps
outside the router.

Under a mesh (``utils.set_mesh``, more than one rank) every tier runs,
SPMD, as one process runs it on the global batch: a table with host-side
state (host_lru, a router over host_lru shards, a remote host_lru table)
prepares the global batch's ids on every rank (``prepare_all``); a
router's shards hold their rows as tables of their own, prepare in shard
order on the calling thread (an eviction gathers rows over the mesh),
read through the mesh lookup and put as the mesh puts; a remote table's
PS ops run on the mesh's first rank alone, which shares their results
(``_remote_lookup_mesh``, ``_remote_puts_mesh``); a serve read is
collective (:func:`_mesh_rows`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.core import dedup as D
from repro_torch.core import embedding_ps as PS
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.core.hotness import HotnessSketch
from repro_torch.core.lru import STORE_DTYPES, LRUEmbeddingStore
from repro_torch.core.mmap_store import TieredHostStore
from repro_torch.kernels import ops as K
from repro_torch.utils import (all_gather, axis_size, batch_axes, flat_index,
                               from_rank0, get_mesh, psum, round_up)


def _prod(shape) -> int:
    return math.prod(int(s) for s in shape)


def _host_ids(ids) -> np.ndarray:
    """Logical ids as a host int64 array (the dedup plan is built on the
    host)."""
    if isinstance(ids, torch.Tensor):
        return ids.detach().cpu().numpy().astype(np.int64)
    return np.asarray(ids, np.int64)


def _n_distinct(flat: np.ndarray, rows: int) -> int:
    return int(np.unique(flat[(flat >= 0) & (flat < rows)]).size)


class EmbeddingBackend:
    """Protocol base. A subclass owns one table's storage; its device state
    is a dict of tensors threaded through by the caller, anything on the
    host (a host_lru table's store and slot map) lives on ``self``.

    The device-side ops accept device ids in two forms: a raw id tensor
    (one row per occurrence) or a :class:`~repro_torch.core.dedup.
    DedupPlan` (``dev`` unique device ids + ``inv`` occurrence -> unique
    inverse), which gathers the unique rows and scatters them through the
    inverse, and whose puts segment-sum the occurrence gradients to unique
    width once, here."""

    spec: EmbeddingSpec
    # set by restore_from_checkpoint when the blob had another shard
    # geometry than this backend (caches restart, queues are dropped)
    last_restore_resharded: bool = False
    # the table's rows live in embedding-PS processes
    # (``repro_torch.net.remote``): the fan-outs below move its ids and
    # rows over the wire and keep its state out of the device state
    remote: bool = False

    # -- host-level ----------------------------------------------------------
    def init(self, generator: torch.Generator, shards: int = 1,
             scale: float = 0.02):
        raise NotImplementedError

    def prepare(self, state, ids, assume_unique: bool = False, counts=None):
        """(state, ids) -> (state, device_ids). Host-level, once per step.
        ``assume_unique`` marks ids as an already-deduped set (a plan's
        unique ids); ``counts`` carries the per-unique occurrence counts."""
        return state, ids

    def prepare_submit(self, state, ids, assume_unique: bool = False,
                       counts=None):
        """Two-phase prepare: submit now, collect later. Returns a thunk
        producing ``(state, device_ids)``, so a caller preparing several
        tables submits them all before it collects any: a remote table
        (``repro_torch.net.remote``) buffers its submit into one coalesced
        frame per PS endpoint and only the collect waits. The in-process
        default defers the blocking :meth:`prepare`."""
        return lambda: self.prepare(state, ids, assume_unique, counts)

    def read_lock(self):
        """The context a serve read holds while it resolves residency and
        enqueues its gathers (host_lru: the backend's lock)."""
        return contextlib.nullcontext()

    def read_rows(self, state, ids):
        """Serve-path read at occurrence width: LOGICAL ids -> ``(rows,
        info)`` with ``rows`` fp32 of shape ``ids.shape + (dim,)`` on the
        table's device, and ``info`` the read gauges ``reads`` (unique ids
        resolved), ``hits`` (served from device-resident rows) and
        ``misses`` (served from a host tier). Read-only. Invalid ids (< 0 or
        >= rows) read as zero rows."""
        arr = _host_ids(ids)
        with self.read_lock():
            arrs, rows, info = self._read_begin(arr, occ=True)
            idx, rows = _upload_read({0: (arrs, rows)},
                                     self.state_device(state))[0]
            out = self._read_end(state, idx, rows, occ=True)
        return out.float(), info

    def read_pooled(self, state, ids):
        """Serve-path read, pooled: LOGICAL ids (B, L) -> ``(pooled,
        info)`` with ``pooled`` the (B, dim) fp32 sum over each bag's valid
        rows and ``info`` the same gauges as :meth:`read_rows`. Read-only."""
        arr = _bags(ids)
        with self.read_lock():
            arrs, rows, info = self._read_begin(arr)
            idx, rows = _upload_read({0: (arrs, rows)},
                                     self.state_device(state))[0]
            bag = self._read_end(state, idx, rows)
        return _bag_all({0: bag})[0], info

    def state_device(self, state) -> torch.device:
        """The device the table's state lives on."""
        return state["table"].device

    def _read_begin(self, arr: np.ndarray, occ: bool = False):
        """The host half of a serve read of LOGICAL ids ``arr`` -> (the
        int32 index arrays to upload, fp32 rows to upload or None, read
        gauges). Pooled reads take (B, L) bags; ``occ`` reads occurrence
        rows of any shape."""
        raise NotImplementedError

    def _read_end(self, state, idx: list, rows, occ: bool = False):
        """The device half of a serve read, on the uploaded arrays: the
        bag kernel's entry ``(table, dev or None, inv, flat)``, or with
        ``occ`` the occurrence rows ``arr.shape + (dim,)``."""
        raise NotImplementedError

    def _resolve_unique(self, uniq: np.ndarray):
        """Serve-read residency of valid unique LOGICAL ids (host, under
        :meth:`read_lock`) -> ``(hit, rows, vecs)``: the mask of the ids
        resident on the device, their table rows (int32), and the fp32
        rows of the others read from a host tier."""
        raise NotImplementedError

    def dedup_rows(self) -> int:
        """Upper bound on distinct device ids one batch can produce — the
        denominator of the dedup capacity rule for this backend."""
        return self.spec.rows

    def dev_rows(self) -> int:
        """Rows of the device id space (the table rows, or the cache
        slots): the capacity rule of puts grouped on the device."""
        return self.spec.rows

    def table_rows(self, dev_ids: torch.Tensor) -> torch.Tensor:
        """Device ids -> the rows of ``state["table"]`` they read, int32;
        padding and ids out of range become -1. The bag kernel reads and
        the put applies at these rows."""
        raise NotImplementedError

    def queue_width(self, n_occ: int) -> int:
        """Width of this table's staleness-queue slots for a batch of
        ``n_occ`` id occurrences: the dedup cap under batch dedup, the raw
        occurrence count on the legacy path."""
        if self.spec.batch_dedup:
            return D.dedup_cap(n_occ, self.dedup_rows())
        return int(n_occ)

    # slot pinning: a pipelined caller pins a batch's device slots between
    # its prepare and its applied put, so a later batch's fault-in cannot
    # recycle rows still in flight. No-ops for device-resident backends.
    def pin_slots(self, dev_ids):
        pass

    def unpin_slots(self, dev_ids):
        pass

    def reset_pins(self):
        pass

    # shard introspection (pipelined callers, metrics): an unsharded
    # backend is one PS "shard", and every put lands on shard 0
    def n_put_shards(self) -> int:
        return 1

    def put_shards(self, dev_ids) -> tuple[int, ...]:
        return (0,)

    def shard_metrics(self) -> dict:
        return {}

    def cache_metrics(self) -> dict:
        """Per-step cache-admission gauges (keys are relative: the prepare
        fan-out prefixes ``cache/<table>/``). Empty for backends without
        an admission policy."""
        return {}

    def queue_init(self, ids_shape, device=None):
        raise NotImplementedError

    def state_for_checkpoint(self, state):
        raise NotImplementedError

    def restore_from_checkpoint(self, blob):
        """Validate a checkpoint blob (host numpy arrays) and return the
        table state to restore, as numpy; the trainer moves it to its
        device."""
        raise NotImplementedError

    # -- device-side ---------------------------------------------------------

    def lookup(self, state, dev_ids):
        """Occurrence activations (*ids.shape, dim), read by the plain
        gather."""
        if D.is_plan(dev_ids):
            acts_u, m = self._plan_unique(state, dev_ids)
            return D.plan_scatter(acts_u, dev_ids.inv), m
        return self._lookup_flat(state, dev_ids)

    def lookup_pooled(self, state, dev_ids):
        """Pooled bags (B, dim) through the bag kernels: a plan reads
        through ``unique_bag``, flat (B, L) device ids (translated to table
        rows, then copied to the table's device) through
        ``embedding_bag``. Returns ``(pooled, metrics)``."""
        table = state["table"]
        if D.is_plan(dev_ids):
            return K.unique_bag(table, self._plan_rows(dev_ids),
                                dev_ids.inv), {}
        return K.embedding_bag(
            table, self.table_rows(dev_ids).to(table.device)), {}

    def _bag_entry(self, state, dev_ids) -> tuple:
        """The bag kernel's entry for a lookup of ``dev_ids``: ``(table,
        dev or None, inv, flat)``, a plan through its table rows, flat
        (B, L) device ids translated to table rows."""
        table = state["table"]
        if D.is_plan(dev_ids):
            return (table, self._plan_rows(dev_ids), dev_ids.inv, False)
        return (table, None, self.table_rows(dev_ids).to(table.device), True)

    def _plan_unique(self, state, plan):
        """A plan's (U, dim) unique rows -> ``(rows, metrics)``."""
        return self._lookup_unique(state, plan.dev)

    def apply_put(self, state, dev_ids, grads):
        if D.is_plan(dev_ids):
            return self._put_plan(state, dev_ids, grads)
        return self._put_flat(state, dev_ids, grads)

    def hybrid_update(self, state, queue, dev_ids, grads):
        if D.is_plan(dev_ids):
            return self._hybrid_plan(state, queue, dev_ids, grads)
        return self._hybrid_flat(state, queue, dev_ids, grads)

    def _plan_rows(self, plan) -> torch.Tensor:
        return plan.rows if plan.rows is not None \
            else self.table_rows(plan.dev)

    def _put_plan(self, state, plan, grads):
        """Plan-driven put through the fused kernel: the segment sums and
        their apply at the plan's table rows, one launch."""
        new, _ = _fused_backward(self.spec, state, plan, grads,
                                 self._plan_rows(plan), None,
                                 apply_self=True)
        return new, {}

    def _hybrid_plan(self, state, queue, plan, grads):
        if self.spec.staleness <= 0 or queue is None:
            st, m = self._put_plan(state, plan, grads)
            return st, queue, m
        _, finish = self._hybrid_begin(state, queue, plan, grads)
        return finish()

    def _hybrid_begin(self, state, queue, plan, grads):
        """A hybrid put up to its push: pop the tau-stale put first (the
        kernel reads the slot before it is overwritten) and fuse its apply
        with this step's segment sums -> ``(payload, finish)``. ``payload``
        is the (U, dim) fresh sums, a view of the queue-ready (cap, dim)
        payload; ``finish()`` pushes the payload into the popped slot
        (queue_push_pop's order) -> (state, queue, metrics). The popped put
        crossed the wire, if any, when it was pushed."""
        raise NotImplementedError

    def _wire_begin(self, state, queue, plan, grads):
        """A put whose unique-width sums cross the wire between their sum
        and the PS, up to the wire: ``(payload, finish)`` as
        :meth:`_hybrid_begin`; the caller roundtrips ``payload`` IN PLACE
        before it calls ``finish()``. In sync mode the sums are a sum-only
        launch here and their apply an apply-only launch in ``finish``.
        Under a mesh the payload is this rank's share of the global put
        (:func:`_wire_begin_mesh`)."""
        if _on_mesh():
            return _wire_begin_mesh(self, state, queue, plan, grads)
        if self.spec.staleness > 0 and queue is not None:
            return self._hybrid_begin(state, queue, plan, grads)
        g_u = D.csr_segment_sum(*_plan_csr(plan), grads,
                                int(plan.dev.shape[0]))

        def finish():
            st, m = self._put_unique(state, plan.dev, g_u)
            return st, queue, m
        return g_u, finish

    def _lookup_flat(self, state, dev_ids):
        raise NotImplementedError

    def _lookup_unique(self, state, dev_u):
        """(U,) unique device ids -> ((U, dim) rows, metrics). Default:
        the flat lookup already handles any id shape."""
        return self._lookup_flat(state, dev_u)

    def _put_flat(self, state, dev_ids, grads):
        raise NotImplementedError

    def _hybrid_flat(self, state, queue, dev_ids, grads):
        raise NotImplementedError

    def _put_unique(self, state, dev_u, g_u):
        """Pre-deduped put: (U,) unique device ids + (U, dim) fp32 summed
        grads."""
        raise NotImplementedError

    def _hybrid_unique(self, state, queue, dev_u, g_u):
        raise NotImplementedError

    def _mesh_unique(self, state, queue, dev_u, ids_u, g_u):
        """Under a mesh, this rank's share of a put that is unique over the
        global batch (device ids, logical ids, fp32 sums): pushed into the
        rank's queue, and the put that pops out applied as the mesh applies
        a put -> (state, queue, metrics)."""
        raise NotImplementedError

    # -- capacity accounting -------------------------------------------------
    def device_bytes(self, state) -> int:
        return sum(int(x.numel()) * x.element_size() for x in state.values())

    def host_bytes(self) -> int:
        return 0


def _plan_csr(plan) -> tuple[torch.Tensor, torch.Tensor]:
    """The plan's occurrence CSR, built on the host from ``inv`` when the
    plan was made by hand without it."""
    if plan.order is not None:
        return plan.order, plan.offsets
    o, f = D.occurrence_csr(plan.inv.cpu().numpy(), plan.dev.shape[0])
    return tuple(torch.from_numpy(a).to(plan.inv.device) for a in (o, f))


def _fused_backward(spec: EmbeddingSpec, state: dict, plan, grads,
                    apply_idx: torch.Tensor, apply_g, *,
                    apply_self: bool = False):
    """One-pass plan-driven put through the ``fused_backward`` kernel:
    segment-sum the occurrence grads along the plan's occurrence CSR, apply
    the optimizer row-wise at ``apply_idx`` (-1 = no-op) in place, return
    ``(state, g_push)`` with ``g_push`` the queue-ready (cap, dim) payload.
    Adagrad updates ``acc``; sgd (no ``acc``) is the plain scaled step."""
    g_push = PS.fused_apply(
        state, spec, *_plan_csr(plan),
        grads.reshape(-1, spec.dim).float().contiguous(), apply_idx,
        None if apply_self else apply_g)
    return state, g_push


def _plan_sums(plan, grads) -> torch.Tensor:
    """The plan's unique-width gradient sums: one sum-only
    ``fused_backward`` launch."""
    return D.csr_segment_sum(*_plan_csr(plan), grads, int(plan.dev.shape[0]))


def _on_mesh() -> bool:
    """A mesh of more than one rank is in scope."""
    mesh = get_mesh()
    return mesh is not None and mesh.n_ranks > 1


def _mesh_rows(backend, state, rows: torch.Tensor) -> torch.Tensor:
    """Under a mesh, the fp32 rows of a dense or host_lru table at (T,)
    table rows (its shuffled rows, or its cache slots; -1 reads zeros),
    ``T`` the same on every rank: through the mesh lookup
    (``embedding_ps._lookup_sharded``, a collective) where the partition
    rules row-shard the state, else read from the rank's whole copy. Each
    row is its owner's value (plus zeros): exact."""
    table = state["table"]
    if isinstance(backend, HostLRUBackend):
        n = backend._cache_split()[0]
        local = backend.dev_slots // n
    else:
        n = PS.n_shards(backend.spec)
        local = backend.spec.padded_rows(n) // n
    if n == 1:
        ok = rows >= 0
        got = table[torch.where(ok, rows, 0).long()]
        return torch.where(ok[:, None], got, 0).float()
    shard_axes, batch = PS._axes_for(backend.spec.mode)
    return PS._lookup_sharded(table, backend.spec, rows.to(torch.int32),
                              shard_axes, batch, local).float()


def _wire_begin_mesh(backend, state, queue, plan, grads):
    """The wire's put under a mesh, up to the wire (``_wire_begin``'s
    contract): this rank's unique-width sums (one sum-only
    ``fused_backward`` launch) are gathered over the batch axes and
    deduplicated again on the logical ids, as the full-mode mesh put does
    (one more sum-only launch), so the codec sees the global put of one
    process (whole rows of blocks: ``check_mesh`` holds the block to the
    dim). The payload is this rank's share of it, the rows [i W, (i + 1)
    W) of the global put (W this rank's width, i its batch index): the
    ranks' shares, gathered, are the put, as a staleness queue is cut.
    ``finish`` sends the share to :meth:`EmbeddingBackend._mesh_unique`."""
    axes = batch_axes()
    key = plan.dev if plan.ids is None else plan.ids
    key_all = all_gather(key.to(torch.int32).contiguous(), axes)
    dev_all = key_all if plan.ids is None else \
        all_gather(plan.dev.to(torch.int32).contiguous(), axes)
    g_all = all_gather(_plan_sums(plan, grads).contiguous(), axes)
    width = int(key_all.shape[0])
    glob = C.dedup_plan(key_all, width)
    sums = D.csr_segment_sum(glob.order, glob.offsets, g_all, width)
    first = glob.order[glob.offsets[:-1].clamp(max=max(width - 1, 0))]
    dev_u = torch.where(glob.dev >= 0, dev_all[first.long()], -1)
    w = int(key.shape[0])
    lo = flat_index(axes) * w
    payload = sums[lo:lo + w]

    def finish():
        return backend._mesh_unique(state, queue, dev_u[lo:lo + w],
                                    glob.dev[lo:lo + w], payload)
    return payload, finish


def _pad_to(arr: np.ndarray, width: int, fill: int = -1) -> np.ndarray:
    """A plan's unique ids (or counts) padded with ``fill`` to ``width``:
    under a mesh every rank's plan has the dedup cap's width, so the ids
    gathered over the batch axes have one width on every rank."""
    out = np.full(width, fill, arr.dtype)
    out[:arr.size] = arr
    return out


class DenseBackend(EmbeddingBackend):
    """Device-resident PS shard; device ids ARE the logical ids.

    Under a mesh (``utils.set_mesh``) whose axes shard the table, its state
    is the rank's row block (``init(shards=n)`` pads the rows to a multiple
    of the n ranks), and it keeps the JAX package's decomposition
    (``_fusable`` is false there): a lookup reads its unique rows through
    the mesh lookup of ``embedding_ps``, which the stage's one bag launch
    pools with the identity for ``dev``; a put sums to unique width
    (a sum-only ``fused_backward`` launch), pushes and pops the rank's own
    queue, and sends the popped put through the mesh put."""

    def __init__(self, spec: EmbeddingSpec):
        if spec.store_dtype != "fp32":
            raise ValueError(
                f"store_dtype={spec.store_dtype!r} compresses cold HOST "
                "rows — the dense backend is fully device-resident; use a "
                "host_lru backend (or drop store_dtype)")
        self.spec = spec

    def init(self, generator: torch.Generator, shards: int = 1,
             scale: float = 0.02):
        return PS.ps_init(generator, self.spec, shards, scale)

    def queue_init(self, ids_shape, device=None):
        if self.spec.staleness <= 0:
            return None
        return self._queue_init_width(self.queue_width(_prod(ids_shape)),
                                      device)

    def _queue_init_width(self, width: int, device=None):
        return PS.queue_init(self.spec, (int(width),), self.spec.dim, device)

    def _lookup_flat(self, state, dev_ids):
        return PS.lookup(state, self.spec, dev_ids), {}

    def _fusable(self) -> bool:
        """False where a mesh in scope shards the table: the fused put is
        the single-shard apply."""
        return PS.n_shards(self.spec) == 1

    def _logical_to_pos(self, ids: torch.Tensor) -> torch.Tensor:
        """Logical id -> physical shuffled row as int32 (over the rows of
        every shard of a mesh in scope); padding and ids out of range (< 0
        or >= rows) become -1."""
        spec = self.spec
        valid = (ids >= 0) & (ids < spec.rows)
        pos = PS.shuffle_pos(torch.where(valid, ids, 0),
                             spec.padded_rows(PS.n_shards(spec)))
        return torch.where(valid, pos, -1).to(torch.int32)

    def _bag_entry(self, state, dev_ids) -> tuple:
        if self._fusable():
            return super()._bag_entry(state, dev_ids)
        if D.is_plan(dev_ids):
            return (PS.lookup(state, self.spec, dev_ids.dev), None,
                    dev_ids.inv, False)
        rows = PS.lookup(state, self.spec, dev_ids)
        return (rows.reshape(-1, self.spec.dim), None, _slots(dev_ids), True)

    def lookup_pooled(self, state, dev_ids):
        if self._fusable():
            return super().lookup_pooled(state, dev_ids)
        return _bag_all({0: self._bag_entry(state, dev_ids)})[0], {}

    def _put_plan(self, state, plan, grads):
        if self._fusable():
            return super()._put_plan(state, plan, grads)
        return self._put_unique(state, plan.dev, _plan_sums(plan, grads))

    def _hybrid_plan(self, state, queue, plan, grads):
        if self._fusable():
            return super()._hybrid_plan(state, queue, plan, grads)
        return self._hybrid_unique(state, queue, plan.dev,
                                   _plan_sums(plan, grads))

    def table_rows(self, dev_ids: torch.Tensor) -> torch.Tensor:
        return self._logical_to_pos(dev_ids)

    def _read_begin(self, arr, occ=False):
        """Pooled: with ``spec.batch_dedup`` the plan's inverse and
        physical rows (for ``unique_bag``), else the occurrence rows (for
        ``embedding_bag``), translated on the host beside the plan. ``occ``:
        the ids themselves, for the plain gather."""
        spec = self.spec
        if occ:
            # negatives stay padding and ids past int32 stay out of range
            arrs = [np.clip(arr, -1, _INT32_MAX)]
            n = _n_distinct(arr.reshape(-1), spec.rows)
        elif spec.batch_dedup:
            cap = D.dedup_cap(max(arr.size, 1), self.dedup_rows())
            u_pad, inv, _, info = D.make_plan(arr, spec.rows, cap)
            if self._fusable():
                u_pad = self._logical_to_pos(torch.from_numpy(u_pad)).numpy()
            else:               # the mesh lookup reads logical ids
                u_pad = _pad_to(u_pad, cap)
            arrs = [inv, u_pad]
            n = info["n_unique"]
        else:
            arrs = [self._logical_to_pos(torch.from_numpy(arr)).numpy()]
            n = _n_distinct(arr.reshape(-1), spec.rows)
        return arrs, None, {"reads": n, "hits": n, "misses": 0}

    def _read_end(self, state, idx, rows, occ=False):
        table = state["table"]
        if occ:
            return self._lookup_flat(state, idx[0])[0]
        if not self._fusable():
            ids = idx[1] if len(idx) == 2 else idx[0]
            return self._bag_entry(
                state, D.DedupPlan(dev=ids, inv=idx[0])
                if len(idx) == 2 else ids)
        if len(idx) == 2:
            return (table, idx[1], idx[0], False)
        return (table, None, idx[0], True)

    def _resolve_unique(self, uniq):
        return (np.ones(uniq.size, bool),
                self._logical_to_pos(torch.from_numpy(uniq)).numpy(),
                np.zeros((0, self.spec.dim), np.float32))

    def _put_unique(self, state, dev_u, g_u):
        return PS.apply_put(state, self.spec, dev_u, g_u,
                            assume_unique=True), {}

    def _put_flat(self, state, dev_ids, grads):
        return PS.apply_put(state, self.spec, dev_ids.reshape(-1),
                            grads.reshape(-1, self.spec.dim)), {}

    def _hybrid_begin(self, state, queue, plan, grads):
        ids_q, g_q = queue["ids"], queue["grads"]
        tau, cap = int(ids_q.shape[0]), int(ids_q.shape[1])
        ptr, U = int(queue["ptr"]), int(plan.dev.shape[0])
        if U > cap:
            raise ValueError(f"plan width {U} exceeds the queue width {cap}")
        new, g_push = _fused_backward(self.spec, state, plan, grads,
                                      self._logical_to_pos(ids_q[ptr]),
                                      g_q[ptr])

        def finish():
            ids_q[ptr, :U] = plan.dev
            ids_q[ptr, U:] = -1
            g_q[ptr] = g_push
            return new, dict(queue, ptr=(ptr + 1) % tau,
                             filled=min(int(queue["filled"]) + 1, tau)), {}
        return g_push[:U], finish

    def _hybrid_flat(self, state, queue, dev_ids, grads):
        spec = self.spec
        flat = dev_ids.reshape(-1)
        g = grads.reshape(-1, spec.dim)
        if spec.staleness <= 0 or queue is None or not spec.batch_dedup:
            # occurrence-width queue; the popped put is aggregated on its
            # physical rows when it is applied
            st, q = PS.hybrid_emb_update(state, queue, spec, flat, g)
            return st, q, {}
        # unique-width queue: the occurrence put is deduplicated BEFORE the
        # push (the same sums the post-queue dedup would produce), so every
        # queued put is one row per unique id
        valid = (flat >= 0) & (flat < spec.rows)
        ids_signed = torch.where(valid, flat, -1)
        plan = C.dedup_plan(ids_signed, int(queue["ids"].shape[1]))
        return self._hybrid_plan(state, queue, plan, g)

    def _hybrid_unique(self, state, queue, dev_u, g_u):
        spec = self.spec
        if spec.staleness <= 0 or queue is None:
            st, m = self._put_unique(state, dev_u, g_u)
            return st, queue, m
        cap = int(queue["ids"].shape[1])
        ids_cap = D.pad_axis0(dev_u.to(torch.int32), cap, -1)
        g_cap = D.pad_axis0(g_u, cap, 0)
        queue, old_ids, old_g = PS.queue_push_pop(queue, ids_cap, g_cap)
        st = PS.apply_put(state, spec, old_ids, old_g, assume_unique=True)
        return st, queue, {}

    def _mesh_unique(self, state, queue, dev_u, ids_u, g_u):
        return self._hybrid_unique(state, queue, ids_u, g_u)

    def state_for_checkpoint(self, state):
        return {k: v.detach().cpu().numpy() for k, v in state.items()}

    def restore_from_checkpoint(self, blob):
        spec = self.spec
        self.last_restore_resharded = False
        if isinstance(blob, dict) and "shard_meta" in blob:
            # a sharded-router checkpoint restored into one shard: gather
            # the logical rows and rebuild (an N -> 1 reshard)
            vec, acc = extract_logical_rows(blob, spec, "dense")
            self.last_restore_resharded = True
            return _dense_state_from_logical(spec, spec.rows, vec, acc)
        table = blob.get("table") if isinstance(blob, dict) else None
        if table is None:
            raise ValueError(
                "checkpoint blob has no 'table' — it was not written by the "
                "dense backend (restoring across backends is not supported)")
        if table.shape[1] != spec.dim or table.shape[0] < spec.rows:
            raise ValueError(
                f"checkpoint table has shape {tuple(table.shape)} but this "
                f"table's spec wants >= ({spec.rows}, {spec.dim}) — "
                "collection changed since the save?")
        return blob


# ===========================================================================
# HostLRUBackend — the out-of-core tier (paper §4.2.2)
# ===========================================================================

class HostLRUBackend(EmbeddingBackend):
    """Device hot-cache of ``spec.cache_rows`` slots over a host
    :class:`~repro_torch.core.lru.LRUEmbeddingStore` holding all
    ``spec.rows`` (vectors and adagrad accumulators, the paper's array-item
    layout), or, under ``+disk``, a host LRU over a memory-mapped disk
    tier (:class:`~repro_torch.core.mmap_store.TieredHostStore`).

    ``prepare`` is the fault path: it resolves the batch's unique ids
    against the slot map, writes the LRU victims' (vector, acc) back to the
    host store, loads the missing rows into their slots and returns the
    batch translated to cache-slot indices. The device-side ops then run on
    the cache: the bag kernel reads slots and ``fused_backward`` applies at
    slots, so a working set that fits in cache is bit-exact with dense
    (where no two ids share a shuffled row).

    Staleness queues store ``(slot, logical id)`` pairs; a popped put whose
    slot has been recycled for another id since it was enqueued is dropped
    (the paper's tolerated lost put). The check reads the device's
    ``slot_ids``, which only the fault-in writes.

    The state lives in place, as the dense backend's does: the eviction's
    gather of the victims' rows and the fault-in's scatter are enqueued on
    the current stream, after the previous step's puts and in that order.
    The host must hold the evicted rows before it writes them to the store,
    so a prepare that evicts waits for the stream once (a device-to-host
    copy); the fault-in goes up through a fresh pinned staging buffer as
    ONE non-blocking copy per table (PyTorch's pinned-memory allocator
    keeps the buffer until its copy is done). ``stage_s`` accumulates the
    host seconds of the eviction (``evict``, of which ``evict_sync`` is
    the wait for the stream) and of the fault-in (``fault``).

    The host tier (slot map, clock, store) is guarded by an RLock, held
    through ``prepare`` and through a serve read's residency resolution
    and its enqueued gathers.

    Under a mesh (``utils.set_mesh``, more than one rank) the tier is the
    JAX package's one LRU over the global batch, SPMD: ``prepare_all``
    gathers the batch's ids over the batch axes and every rank runs the
    same prepare on them, so every rank's slot map, store, clock and
    counters are those of one process, bit for bit; each rank's plan
    then reads its own rows' slots. The device cache is laid out by the
    partition rules (``emb_state_specs``): row-sharded over the table's
    shard axes where they divide the slots (:meth:`_cache_split`), else
    replicated. A sharded cache reads through the mesh lookup
    (``embedding_ps._lookup_sharded``, the slot as the position), a rank
    faults rows into its own slots only, and the rows an eviction writes
    back are gathered over the shard axes first. A put sums to unique
    width, pushes the rank's own queue, and the put that pops out is
    gathered over the batch axes, deduplicated on the slots and applied
    where the rank holds the slot (:meth:`_mesh_apply`). ``+disk`` takes a
    directory per rank (``disk_path/r<rank>``). A serve read under a mesh
    resolves each rank's own requests against the slot map and the store
    and reads its hits through the mesh lookup by slot (a row-sharded
    cache); nothing of the tier moves. An occurrence-width table
    (``batch_dedup=False``) prepares the global batch as a dedup table
    does, reads its occurrences' slots through the same lookup, and
    queues and applies its occurrence-width puts through
    :meth:`_mesh_apply`."""

    def __init__(self, spec: EmbeddingSpec):
        if spec.cache_rows <= 0:
            raise ValueError(
                "host_lru backend needs EmbeddingSpec.cache_rows > 0 "
                f"(got {spec.cache_rows})")
        if spec.optimizer not in ("adagrad", "sgd"):
            raise ValueError(spec.optimizer)
        if spec.store_dtype not in STORE_DTYPES:
            raise ValueError(
                f"unknown store_dtype {spec.store_dtype!r}: one of "
                f"{STORE_DTYPES}")
        self.spec = spec
        self.cache_rows = int(spec.cache_rows)
        self._disk = "disk" in (spec.backend or "").split("+")
        # frequency-aware admission: ids below admit_threshold are served
        # from BYPASS slots appended after the main cache, so a once-seen
        # cold id never evicts a hot resident; admit_threshold <= 0 turns
        # the sketch off
        self.admit_threshold = float(spec.admit_threshold)
        if self.admit_threshold > 0:
            self.bypass_rows = (int(spec.bypass_rows)
                                or max(1, self.cache_rows // 4))
            self._sketch: HotnessSketch | None = HotnessSketch()
        else:
            self.bypass_rows = 0
            self._sketch = None
        self.dev_slots = self.cache_rows + self.bypass_rows
        self.store: LRUEmbeddingStore | TieredHostStore | None = None
        self._lock = threading.RLock()
        self.stage_s = {"evict": 0.0, "evict_sync": 0.0, "fault": 0.0}
        self._reset_slots()

    def _reset_slots(self):
        spec = self.spec
        # _slot_for_id (dict) is authoritative for the sparse mutations;
        # _slot_arr (id -> slot, -1 = absent) and _id_for_slot (slot -> id)
        # are its vectorised mirrors
        self._slot_for_id: dict[int, int] = {}
        self._slot_arr = np.full(spec.rows, -1, np.int32)
        self._id_for_slot = np.full(self.dev_slots, -1, np.int64)
        self._slot_clock = np.zeros(self.dev_slots, np.int64)
        self._pin_count = np.zeros(self.dev_slots, np.int32)
        self._tick = 0
        self.faults = 0          # rows moved host -> device
        self.writebacks = 0      # rows moved device -> host
        self.hits = 0            # unique ids resolved without a fault
        self.admits = 0          # faults granted a main-cache slot
        self.bypasses = 0        # faults served from the bypass region
        self.promotes = 0        # bypass rows re-admitted once hot
        self.last_admit = 0      # per-step versions of the three above
        self.last_bypass = 0
        self.last_promote = 0

    # -- host-level ----------------------------------------------------------

    def init(self, generator: torch.Generator, shards: int = 1,
             scale: float = 0.02):
        """Draw the SAME table the dense backend would from ``generator``
        (on its device, then copied out) and park it host-side: the host
        row of id i is what a dense lookup of i reads (``table[
        shuffle_pos(i)]``). The device cache starts empty, on the
        generator's device. Under a mesh ``shards`` may be the ranks that
        shard the table (the cache's layout, not PS shards)."""
        if shards not in (1, PS.n_shards(self.spec)):
            raise ValueError(
                "HostLRUBackend is one PS shard; to run a host-backed table "
                f"over {shards} shards set EmbeddingSpec.emb_shards (or pass "
                "emb_shards to PersiaTrainer.init), which routes through the "
                "ShardedBackend router")
        spec = self.spec
        dense = PS.ps_init(generator, dataclasses.replace(spec,
                                                          backend="dense"),
                           1, scale)["table"]
        pos = PS.shuffle_pos(torch.arange(spec.rows), spec.padded_rows(1))
        table = dense.float().cpu().numpy()[pos.numpy()]
        del dense
        with self._lock:
            return self._init_with_rows_locked(np.arange(spec.rows), table,
                                               device=generator.device)

    def _init_with_rows(self, ids, vecs, accs=None, device="cpu"):
        """Fresh run seeded with explicit host rows: ids land in the host
        store, the device cache (on ``device``) starts empty, all slot
        bookkeeping is reset."""
        with self._lock:
            return self._init_with_rows_locked(ids, vecs, accs, device)

    def _make_store(self):
        """The host tier: a plain all-rows LRU store (it never evicts, so
        the fault path skips its recency upkeep), or, under ``+disk``, the
        tiered host-over-mmap store whose host tier spills to disk."""
        spec = self.spec
        if self._disk:
            host_rows = int(spec.host_rows) or max(1024, spec.rows // 4)
            return TieredHostStore(spec.rows, spec.dim,
                                   host_rows=host_rows,
                                   path=self._disk_path(),
                                   store_dtype=spec.store_dtype)
        return LRUEmbeddingStore(spec.rows, spec.dim, track_recency=False,
                                 store_dtype=spec.store_dtype)

    def _disk_path(self):
        """The disk tier's directory: under a mesh one per rank
        (``disk_path/r<rank>``), as the router takes ``disk_path/s<k>``."""
        path, mesh = self.spec.disk_path, get_mesh()
        if path is None or not _on_mesh():
            return path
        return os.path.join(path, f"r{mesh.rank}")

    def _init_with_rows_locked(self, ids, vecs, accs=None, device="cpu"):
        spec = self.spec
        self.store = self._make_store()
        self.store.preload(np.asarray(ids, np.int64),
                           np.asarray(vecs, np.float32), accs)
        self._reset_slots()
        if self._sketch is not None:
            self._sketch = HotnessSketch()
        state = {
            "table": torch.zeros((self.dev_slots, spec.dim), dtype=spec.dtype,
                                 device=device),
            "slot_ids": torch.full((self.dev_slots,), -1, dtype=torch.int32,
                                   device=device),
        }
        if spec.optimizer == "adagrad":
            state["acc"] = torch.zeros((self.dev_slots,), dtype=torch.float32,
                                       device=device)
        return state

    def prepare(self, state, ids, assume_unique: bool = False, counts=None):
        """Fault the batch's rows into the device cache; translate ids to
        cache-slot indices (-1 for padding / out-of-range), as host int32
        for host ids or as a tensor on the cache's device for a tensor.
        ``assume_unique=True`` (the plan path) skips the np.unique: the
        caller already deduplicated the batch. Thread-safe: the whole
        fault-in is one critical section."""
        with self._lock:
            st, dev = self._prepare_locked(state, _host_ids(ids),
                                           assume_unique, counts)
        if isinstance(ids, torch.Tensor):
            dev = torch.from_numpy(dev).to(state["table"].device)
        return st, dev

    def _split_admission(self, missing: np.ndarray,
                         hit_slots: np.ndarray) -> tuple[np.ndarray,
                                                         np.ndarray]:
        """Partition this step's missing ids into (admitted, bypassed) by
        sketch hotness. Bypassed faults are capped by the bypass slots
        actually free this step (unpinned and not holding a row the batch
        also hits); the overflow is admitted, from the front of the bypass
        list, so a cold burst can still be served."""
        hot = self._sketch.estimate(missing) >= self.admit_threshold
        admit, bypass = missing[hot], missing[~hot]
        if bypass.size:
            avail = np.ones(self.dev_slots, bool)
            avail[: self.cache_rows] = False
            avail[self._pin_count > 0] = False
            avail[hit_slots] = False
            room = int(np.count_nonzero(avail))
            if bypass.size > room:
                admit = np.concatenate([admit, bypass[room:]])
                bypass = bypass[:room]
        return admit, bypass

    def _prepare_locked(self, state, ids: np.ndarray,
                        assume_unique: bool = False, counts=None):
        spec = self.spec
        flat = ids.reshape(-1)
        valid = (flat >= 0) & (flat < spec.rows)
        uniq = flat[valid] if assume_unique else np.unique(flat[valid])
        if uniq.size > self.cache_rows:
            raise ValueError(
                f"batch working set ({uniq.size} unique ids) exceeds the "
                f"device cache ({self.cache_rows} slots) — raise "
                "EmbeddingSpec.cache_rows or shrink the batch")
        self._tick += 1
        if self._sketch is not None:
            c = None
            if counts is not None:
                c = np.asarray(counts, np.float64).reshape(-1)
                c = c[valid] if c.size == flat.size else None
            self._sketch.update(uniq, c)
        uslots = self._slot_arr[uniq].astype(np.int64)
        self.last_admit = self.last_bypass = self.last_promote = 0
        if self._sketch is not None:
            # promote bypass-resident rows that have become hot: write the
            # device copy back, free the bypass slot, and let the fault
            # path re-admit them into the main cache this same step
            # (pinned slots wait for a later step)
            in_byp = uslots >= self.cache_rows
            if in_byp.any():
                hot = self._sketch.estimate(uniq) >= self.admit_threshold
                safe = np.clip(uslots, 0, self.dev_slots - 1)
                promo = in_byp & hot & (self._pin_count[safe] == 0)
                if promo.any():
                    self._evict_slots(uslots[promo], state)
                    uslots[promo] = -1
                    self.last_promote = int(promo.sum())
                    self.promotes += self.last_promote
        hit_slots = uslots[uslots >= 0]
        missing = uniq[uslots < 0]
        self.hits += int(hit_slots.size)
        if missing.size:
            if self._sketch is not None:
                admit, bypass = self._split_admission(missing, hit_slots)
                v_main = self._free_slots(hit_slots, admit.size, state,
                                          hi=self.cache_rows)
                v_byp = self._free_slots(hit_slots, bypass.size, state,
                                         lo=self.cache_rows)
                missing = np.concatenate([admit, bypass])
                victims = np.concatenate([v_main, v_byp])
                self.admits += int(admit.size)
                self.bypasses += int(bypass.size)
                self.last_admit = int(admit.size)
                self.last_bypass = int(bypass.size)
            else:
                victims = self._free_slots(hit_slots, missing.size, state)
                self.admits += int(missing.size)
                self.last_admit = int(missing.size)
            t0 = time.perf_counter()
            vecs, accs = self.store.read_rows(missing)
            self.faults += missing.size
            self._fault_in(state, victims, missing, vecs, accs)
            self.stage_s["fault"] += time.perf_counter() - t0
            for k, s in zip(missing.tolist(), victims.tolist()):
                self._slot_for_id[k] = s
            self._slot_arr[missing] = victims
            self._id_for_slot[victims] = missing
            touched = np.concatenate([hit_slots, victims])
        else:
            touched = hit_slots
        self._slot_clock[touched] = self._tick
        dev = np.where(valid, self._slot_arr[np.where(valid, flat, 0)], -1)
        return state, dev.astype(np.int32).reshape(ids.shape)

    def _fault_in(self, state, slots, ids, vecs, accs):
        """Scatter the faulted rows into their slots, in place: slots,
        ids, accs and vectors travel in ONE staging buffer and one
        host-to-device copy (pinned and non-blocking on a GPU). A
        row-sharded cache under a mesh takes the rows of its own slots."""
        n, i = self._cache_split()
        if n > 1:
            rl = self.dev_slots // n
            mine = slots // rl == i
            slots, ids = slots[mine] - i * rl, ids[mine]
            vecs = np.asarray(vecs)[mine]
            accs = None if accs is None else np.asarray(accs)[mine]
        m, dim = int(slots.size), self.spec.dim
        if m == 0:
            return
        has_acc = "acc" in state
        base = 3 * m if has_acc else 2 * m
        buf = np.empty(base + m * dim, np.int32)
        buf[:m] = slots
        buf[m:2 * m] = ids
        words = buf.view(np.float32)
        if has_acc:
            words[2 * m:3 * m] = accs
        words[base:] = np.asarray(vecs, np.float32).reshape(-1)
        table = state["table"]
        up = torch.from_numpy(buf)
        if table.device.type == "cuda":
            up = up.pin_memory().to(table.device, non_blocking=True)
        idx = up[:m].long()
        fl = up.view(torch.float32)
        table.index_copy_(0, idx, fl[base:].view(m, dim).to(table.dtype))
        state["slot_ids"].index_copy_(0, idx, up[m:2 * m])
        if has_acc:
            state["acc"].index_copy_(0, idx, fl[2 * m:3 * m])

    def _free_slots(self, protected: np.ndarray, need: int, state,
                    lo: int = 0, hi: int | None = None):
        """Pick ``need`` victim slots inside ``[lo, hi)`` (the full slot
        pool by default; admission carves it into the main cache ``[0,
        cache_rows)`` and the bypass region ``[cache_rows, dev_slots)``):
        empty slots first, then the least-recently-touched occupied slots
        outside the current batch (never a pinned slot); evicted rows
        (vector + acc) are written back to the host store."""
        if hi is None:
            hi = self.dev_slots
        if need <= 0:
            return np.zeros(0, np.int64)
        in_region = np.zeros(self.dev_slots, bool)
        in_region[lo:hi] = True
        pinned = self._pin_count > 0
        free = np.nonzero((self._id_for_slot < 0) & ~pinned
                          & in_region)[0][:need]
        n_evict = need - free.size
        if n_evict <= 0:
            return free
        cand = in_region.copy()
        cand[self._id_for_slot < 0] = False
        cand[protected] = False
        cand[pinned] = False
        cand_slots = np.nonzero(cand)[0]
        if cand_slots.size < n_evict:
            raise ValueError(
                f"fault-in needs {n_evict} eviction victims but only "
                f"{cand_slots.size} unpinned slots are evictable: the "
                f"combined working set of in-flight pipelined batches "
                f"exceeds the device cache ({hi - lo} slots in "
                f"[{lo}, {hi}), {int(pinned.sum())} pinned) — lower "
                "max_inflight or raise EmbeddingSpec.cache_rows")
        order = np.argsort(self._slot_clock[cand_slots], kind="stable")
        evict = cand_slots[order[:n_evict]]
        self._evict_slots(evict, state)
        return np.concatenate([free, evict])

    def _evict_slots(self, evict: np.ndarray, state):
        """Write the given occupied slots' rows (vector + acc: the device
        copy is the freshest) back to the host store and clear their slot
        bookkeeping. The gather is enqueued after every put before it; the
        copy to the host waits for it."""
        t0 = time.perf_counter()
        n, dim = int(evict.size), self.spec.dim
        ev_ids = self._id_for_slot[evict]
        rows = self._rows_at(state, evict)
        t1 = time.perf_counter()
        host = rows.cpu().numpy()
        self.stage_s["evict_sync"] += time.perf_counter() - t1
        accs = host[:, dim].copy() if "acc" in state else None
        self.store.write_rows(ev_ids, np.ascontiguousarray(host[:, :dim]),
                              accs)
        self.writebacks += n
        for k in ev_ids.tolist():
            del self._slot_for_id[k]
        self._slot_arr[ev_ids] = -1
        self._id_for_slot[evict] = -1
        self.stage_s["evict"] += time.perf_counter() - t0

    def _rows_at(self, state, slots: np.ndarray) -> torch.Tensor:
        """The (E, dim [+ 1]) fp32 rows (and accumulators) at host
        ``slots``, on the cache's device. A row-sharded cache reads its own
        slots and gathers the others' over the shard axes (each row taken
        from its owner's block: exact)."""
        table = state["table"]
        idx = upload_int32([slots], table.device)[0].long()
        n, i = self._cache_split()
        if n > 1:
            rl = self.dev_slots // n
            owner = idx // rl
            idx = torch.where(owner == i, idx - i * rl, 0)
        rows = table.index_select(0, idx).float()
        if "acc" in state:
            rows = torch.cat([rows, state["acc"].index_select(0, idx)[:, None]],
                             1)
        if n > 1:
            got = all_gather(rows.contiguous(),
                             PS._axes_for(self.spec.mode)[0])
            rows = got.view(n, *rows.shape)[
                owner, torch.arange(rows.shape[0], device=rows.device)]
        return rows

    def _cache_split(self) -> tuple[int, int]:
        """(the ranks the device cache's slots are cut over, this rank's
        index among them): the partition rules' layout (the table's shard
        axes where they divide the slots, ``_guard``'s rule), (1, 0) for a
        replicated cache or with no mesh."""
        n = PS.n_shards(self.spec)
        if n <= 1 or self.dev_slots % n:
            return 1, 0
        return n, flat_index(PS._axes_for(self.spec.mode)[0])

    # -- slot pinning (pipelined callers) ------------------------------------
    #
    # Between a batch's prepare and its applied put, a deep pipeline must
    # keep that batch's cache slots resident: a later batch's fault-in that
    # recycled them would make the pending lookup read the WRONG row and
    # silently drop the put. Pins are reference counts; a fault-in that
    # cannot find enough unpinned victims raises.

    def _pin_targets(self, dev_ids) -> np.ndarray:
        """The slots to pin: a plan's host copy of its device ids (no
        device-to-host copy), else the ids themselves."""
        host = dev_ids.host if D.is_plan(dev_ids) else None
        slots = _host_ids(D.plan_dev(dev_ids) if host is None
                          else host).reshape(-1)
        return slots[(slots >= 0) & (slots < self.dev_slots)]

    def pin_slots(self, dev_ids):
        slots = self._pin_targets(dev_ids)
        with self._lock:
            np.add.at(self._pin_count, slots, 1)

    def unpin_slots(self, dev_ids):
        slots = self._pin_targets(dev_ids)
        with self._lock:
            np.subtract.at(self._pin_count, slots, 1)
            np.maximum(self._pin_count, 0, out=self._pin_count)

    def reset_pins(self):
        with self._lock:
            self._pin_count[:] = 0

    # -- serve-path read (read-only) -----------------------------------------

    def read_lock(self):
        return self._lock

    def _read_begin(self, arr, occ=False):
        """Resolve residency against the host mirror of the slot map and
        read the misses from the host store, quantized through the cache
        dtype (a served row is the same whether it is cached or not). The
        unique ids are reordered hits first: the arrays to upload are the
        occurrence inverse into that order and the hit slots, the rows to
        upload the misses. Call under :meth:`read_lock` with the
        matching :meth:`_read_end`.

        Under a mesh every rank reads its own block of requests at the
        same time (blocks of one shape; the slot map and the store are
        every rank's): the hit slots are padded with -1 to the block's
        size, so a row-sharded cache reads them through the mesh lookup
        (:func:`_mesh_rows`), and the misses follow the padded hits."""
        spec = self.spec
        flat = arr.reshape(-1)
        valid = (flat >= 0) & (flat < spec.rows)
        uniq, inv_valid = np.unique(flat[valid], return_inverse=True)
        hit, hit_slots, m_vecs = self._resolve_unique(uniq)
        n_hit = int(hit.sum())
        if _on_mesh():
            hit_slots = _pad_to(hit_slots, max(flat.size, 1))
        new_pos = np.empty(uniq.size, np.int64)
        new_pos[hit] = np.arange(n_hit)
        new_pos[~hit] = hit_slots.size + np.arange(int((~hit).sum()))
        inv = np.full(flat.shape, -1, np.int32)
        inv[valid] = new_pos[inv_valid]
        return ([inv.reshape(arr.shape), hit_slots], m_vecs,
                {"reads": int(uniq.size), "hits": int(hit.sum()),
                 "misses": int((~hit).sum())})

    def _resolve_unique(self, uniq):
        """Hits from the host mirror of the slot map; misses read from the
        host store, quantized through the cache dtype (a served row is the
        same whether it is cached or not)."""
        spec = self.spec
        slots = self._slot_arr[uniq]
        hit = slots >= 0
        missing = uniq[~hit]
        m_vecs, _ = self.store.read_rows(missing) if missing.size \
            else (np.zeros((0, spec.dim), np.float32), None)
        m_vecs = torch.from_numpy(np.asarray(m_vecs, np.float32)) \
            .to(spec.dtype).float().numpy()
        return hit, slots[hit].astype(np.int32), m_vecs

    def _read_end(self, state, idx, rows, occ=False):
        """Gather the hits from the device cache beside the uploaded
        misses: the read's unique rows, hits first (at least one row, so
        an empty read still pools zeros)."""
        inv, hit_slots = idx
        table = state["table"]
        hits = _mesh_rows(self, state, hit_slots) if _on_mesh() else \
            table.index_select(0, hit_slots.long()).float()
        rows_u = torch.cat([hits, rows])
        if rows_u.shape[0] == 0:
            rows_u = table.new_zeros((1, self.spec.dim), dtype=torch.float32)
        if occ:
            return D.plan_scatter(rows_u, inv)
        return (rows_u, None, inv, False)

    def dedup_rows(self) -> int:
        # a batch's unique set must fit the device cache (prepare raises
        # otherwise), so the cache bounds the distinct device ids too
        return min(self.spec.rows, self.cache_rows)

    def dev_rows(self) -> int:
        return self.dev_slots

    def table_rows(self, dev_ids: torch.Tensor) -> torch.Tensor:
        valid = (dev_ids >= 0) & (dev_ids < self.dev_slots)
        return torch.where(valid, dev_ids, -1).to(torch.int32)

    def queue_init(self, ids_shape, device=None):
        if self.spec.staleness <= 0:
            return None
        return self._queue_init_width(self.queue_width(_prod(ids_shape)),
                                      device)

    def _queue_init_width(self, width: int, device=None):
        """The FIFO of tau pending puts at ``width``: each holds the cache
        slots, their logical ids and the grads (``ptr``/``filled`` host
        ints, as the dense queue's)."""
        spec = self.spec
        tau, n = spec.staleness, int(width)
        i32 = dict(dtype=torch.int32, device=device)
        return {"slots": torch.full((tau, n), -1, **i32),
                "ids": torch.full((tau, n), -1, **i32),
                "grads": torch.zeros((tau, n, spec.dim), dtype=spec.dtype,
                                     device=device),
                "ptr": 0, "filled": 0}

    # -- device-side ---------------------------------------------------------

    def _safe(self, slots: torch.Tensor) -> torch.Tensor:
        return slots.clamp(0, self.dev_slots - 1).long()

    def _logical(self, state, slots: torch.Tensor) -> torch.Tensor:
        """The logical ids the cache holds at ``slots`` (-1 where < 0); a
        row-sharded cache under a mesh reads them through the mesh
        lookup (every rank's ``slots`` of one width)."""
        if self._cache_split()[0] > 1:
            n = self._cache_split()[0]
            shard_axes, batch = PS._axes_for(self.spec.mode)
            got = PS._lookup_sharded(state["slot_ids"][:, None], self.spec,
                                     self.table_rows(slots), shard_axes,
                                     batch, self.dev_slots // n)[:, 0]
            return torch.where(slots >= 0, got, -1).to(torch.int32)
        return torch.where(slots >= 0, state["slot_ids"][self._safe(slots)],
                           -1).to(torch.int32)

    def _still(self, state, old_slots, old_ids) -> torch.Tensor:
        """A popped put lands only if its slot still holds its row."""
        return (old_slots >= 0) & (old_ids >= 0) & \
            (state["slot_ids"][self._safe(old_slots)] == old_ids)

    def _lookup_flat(self, state, dev_ids):
        shape = dev_ids.shape
        flat = dev_ids.reshape(-1)
        if self._cache_split()[0] > 1:
            out = self._sharded_rows(state, flat)
            return out.reshape(*shape, self.spec.dim), {}
        valid = (flat >= 0) & (flat < self.dev_slots)
        table = state["table"]
        out = table[self._safe(flat)] * valid[:, None].to(table.dtype)
        return out.reshape(*shape, self.spec.dim), {}

    def _sharded_rows(self, state, slots: torch.Tensor) -> torch.Tensor:
        """The rows of a row-sharded cache at (T,) slots (-1 padding):
        ``embedding_ps``'s mesh lookup with the slot as the position (no
        shuffle); each row is its owner's value plus zeros (exact)."""
        n, _ = self._cache_split()
        shard_axes, batch = PS._axes_for(self.spec.mode)
        return PS._lookup_sharded(state["table"], self.spec,
                                  self.table_rows(slots), shard_axes, batch,
                                  self.dev_slots // n)

    def _bag_entry(self, state, dev_ids) -> tuple:
        if self._cache_split()[0] == 1:
            return super()._bag_entry(state, dev_ids)
        if D.is_plan(dev_ids):
            return (self._sharded_rows(state, self._plan_rows(dev_ids)),
                    None, dev_ids.inv, False)
        rows = self._sharded_rows(state, dev_ids.reshape(-1))
        return (rows, None, _slots(dev_ids), True)

    def lookup_pooled(self, state, dev_ids):
        if self._cache_split()[0] == 1:
            return super().lookup_pooled(state, dev_ids)
        return _bag_all({0: self._bag_entry(state, dev_ids)})[0], {}

    def _put_plan(self, state, plan, grads):
        if not _on_mesh():
            return super()._put_plan(state, plan, grads)
        return self._mesh_apply(state, plan.dev, None,
                                _plan_sums(plan, grads)), {}

    def _hybrid_plan(self, state, queue, plan, grads):
        if not _on_mesh():
            return super()._hybrid_plan(state, queue, plan, grads)
        ids = plan.ids if plan.ids is not None \
            else self._logical(state, plan.dev)
        return self._mesh_unique(state, queue, plan.dev, ids,
                                 _plan_sums(plan, grads))

    def _mesh_unique(self, state, queue, dev_u, ids_u, g_u):
        if self.spec.staleness <= 0 or queue is None:
            return self._mesh_apply(state, dev_u, None, g_u), queue, {}
        cap = int(queue["slots"].shape[1])
        queue, old_slots, old_ids, old_g = self._queue_push_pop(
            queue, D.pad_axis0(dev_u.to(torch.int32), cap, -1),
            D.pad_axis0(ids_u.to(torch.int32), cap, -1),
            D.pad_axis0(g_u, cap, 0))
        return self._mesh_apply(state, old_slots, old_ids, old_g), queue, {}

    def _mesh_apply(self, state, slots, ids, g):
        """A put under a mesh, in place: every batch rank's (slots, grads)
        gathered over the batch axes, deduplicated on the slots this rank
        holds (the slot map is every rank's) and applied there, the sums
        and the apply in one ``fused_backward`` launch. With the popped
        put's logical ``ids``, an entry lands only where its slot still
        holds its row (:meth:`_still`, on the gathered entries)."""
        axes = PS._axes_for(self.spec.mode)[1]
        slots = all_gather(self.table_rows(slots).contiguous(), axes)
        g = all_gather(g.float().contiguous(), axes)
        if ids is not None:
            ids = all_gather(ids.to(torch.int32).contiguous(), axes)
        return self._mesh_apply_gathered(state, slots, ids, g)

    def _mesh_apply_gathered(self, state, slots, ids, g):
        """:meth:`_mesh_apply` on the entries every batch rank holds
        (gathered: table rows, logical ids or None, fp32 grads)."""
        n, i = self._cache_split()
        rl = self.dev_slots // n
        keep = (slots >= 0) & (slots // rl == i)
        local = torch.where(keep, slots - i * rl, 0)
        if ids is not None:
            keep &= (ids >= 0) & (state["slot_ids"][local.long()] == ids)
        plan = C.dedup_plan(torch.where(keep, local, -1),
                            min(int(slots.numel()), rl))
        PS.fused_apply(state, self.spec, plan.order, plan.offsets, g,
                       plan.dev, None)
        return state

    def _put_flat(self, state, dev_ids, grads):
        spec = self.spec
        flat = dev_ids.reshape(-1)
        if _on_mesh():
            return self._mesh_apply(state, flat, None,
                                    grads.reshape(-1, spec.dim)), {}
        valid = (flat >= 0) & (flat < self.dev_slots)
        plan = C.dedup_plan(torch.where(valid, flat, -1),
                            D.dedup_cap(int(flat.numel()), self.dev_slots))
        PS.fused_apply(state, spec, plan.order, plan.offsets,
                       grads.reshape(-1, spec.dim).float().contiguous(),
                       plan.dev, None)
        return state, {}

    def _put_unique(self, state, slots_u, g_u):
        return PS._apply_sparse(state, self.spec, self.table_rows(slots_u),
                                g_u), {}

    def _hybrid_flat(self, state, queue, dev_ids, grads):
        spec = self.spec
        flat = dev_ids.reshape(-1)
        g = grads.reshape(-1, spec.dim)
        if spec.staleness <= 0 or queue is None:
            st, m = self._put_flat(state, flat, g)
            return st, queue, m
        slot_signed = self.table_rows(flat)
        if _on_mesh() and not spec.batch_dedup:
            # the rank's occurrences pushed with the ids their slots hold,
            # the popped put gathered and applied as the mesh applies one
            return self._mesh_unique(state, queue, slot_signed,
                                     self._logical(state, slot_signed), g)
        if not spec.batch_dedup:
            return self._hybrid_flat_legacy(state, queue, slot_signed, g)
        # unique-width queue: dedup by slot before the push
        plan = C.dedup_plan(slot_signed, int(queue["slots"].shape[1]))
        return self._hybrid_plan(state, queue, plan, g)

    def _hybrid_flat_legacy(self, state, queue, slot_signed, g):
        """The occurrence-width queue: push every occurrence's (slot, id,
        grad), apply the popped put where its slots still hold its rows."""
        queue, old_slots, old_ids, old_g = self._queue_push_pop(
            queue, slot_signed, self._logical(state, slot_signed), g)
        st, m = self._put_flat(
            state, torch.where(self._still(state, old_slots, old_ids),
                               old_slots, -1), old_g)
        return st, queue, m

    def _hybrid_begin(self, state, queue, plan, grads):
        slots_q, ids_q, g_q = queue["slots"], queue["ids"], queue["grads"]
        tau, cap = int(slots_q.shape[0]), int(slots_q.shape[1])
        ptr, U = int(queue["ptr"]), int(plan.dev.shape[0])
        if U > cap:
            raise ValueError(f"plan width {U} exceeds the queue width {cap}")
        old_slots = slots_q[ptr]
        apply_idx = torch.where(self._still(state, old_slots, ids_q[ptr]),
                                old_slots, -1)
        logical = self._logical(state, plan.dev)
        new, g_push = _fused_backward(self.spec, state, plan, grads,
                                      apply_idx, g_q[ptr])

        def finish():
            slots_q[ptr, :U] = plan.dev
            slots_q[ptr, U:] = -1
            ids_q[ptr, :U] = logical
            ids_q[ptr, U:] = -1
            g_q[ptr] = g_push
            return new, dict(queue, ptr=(ptr + 1) % tau,
                             filled=min(int(queue["filled"]) + 1, tau)), {}
        return g_push[:U], finish

    def _hybrid_unique(self, state, queue, slots_u, g_u):
        spec = self.spec
        if spec.staleness <= 0 or queue is None:
            st, m = self._put_unique(state, slots_u, g_u)
            return st, queue, m
        cap = int(queue["slots"].shape[1])
        slots_cap = D.pad_axis0(slots_u.to(torch.int32), cap, -1)
        queue, old_slots, old_ids, old_g = self._queue_push_pop(
            queue, slots_cap, self._logical(state, slots_cap),
            D.pad_axis0(g_u, cap, 0))
        st, m = self._put_unique(
            state, torch.where(self._still(state, old_slots, old_ids),
                               old_slots, -1), old_g)
        return st, queue, m

    def _queue_push_pop(self, queue, slots, logical, g):
        """Push (slots, ids, grads) at ``ptr``; pop (copies of) the
        tau-stale entry."""
        ptr = int(queue["ptr"])
        old = [queue[k][ptr].clone() for k in ("slots", "ids", "grads")]
        queue["slots"][ptr] = slots.to(torch.int32)
        queue["ids"][ptr] = logical.to(torch.int32)
        queue["grads"][ptr] = g.to(queue["grads"].dtype)
        tau = int(queue["slots"].shape[0])
        return (dict(queue, ptr=(ptr + 1) % tau,
                     filled=min(int(queue["filled"]) + 1, tau)), *old)

    # -- checkpoint ----------------------------------------------------------

    def state_for_checkpoint(self, state):
        """Snapshot ALL tiers: the device cache (so queued slot references
        stay live across restore), the host store (plain or tiered, with
        its recency order), the slot map and, with admission on, the
        hotness sketch: a restore resumes bit-identically. The JAX
        package's blob, key for key."""
        with self._lock:
            cm = {
                "id_for_slot": self._id_for_slot.copy(),
                "slot_clock": self._slot_clock.copy(),
                "scalars": np.array([self._tick, self.faults,
                                     self.writebacks, self.hits,
                                     self.admits, self.bypasses,
                                     self.promotes], np.int64),
            }
            if self._sketch is not None:
                cm["hotness"] = self._sketch.serialize()
            return {"cache": {k: v.detach().cpu().numpy()
                              for k, v in state.items()},
                    "store": self.store.serialize(),
                    "cache_meta": cm}

    def restore_from_checkpoint(self, blob):
        """Load a host_lru blob's host tiers into this backend and return
        its device cache as numpy (``{"table", "slot_ids", "acc"?}``). A
        blob of the other store format (two-tier into ``+disk`` or the
        reverse) is rebuilt row-exactly from its logical rows; a blob of
        the other ``store_dtype`` is re-encoded."""
        self.last_restore_resharded = False
        if isinstance(blob, dict) and "shard_meta" in blob:
            # a sharded-router checkpoint restored into one shard: gather
            # the logical rows (device caches over host stores) and rebuild
            # the tiers (an N -> 1 reshard; queued puts are dropped, the
            # paper's tolerated in-flight loss)
            vec, acc = extract_logical_rows(blob, self.spec, "host_lru")
            state = self._init_with_rows(np.arange(self.spec.rows), vec, acc)
            self.last_restore_resharded = True
            return {k: v.numpy() for k, v in state.items()}
        with self._lock:
            return self._restore_locked(blob)

    def _restore_locked(self, blob):
        spec = self.spec
        if not isinstance(blob, dict) or "store" not in blob \
                or "cache" not in blob:
            raise ValueError(
                "checkpoint blob has no host store — it was not written by "
                "the host_lru backend (restoring across backends is not "
                "supported)")
        meta = blob["store"]["meta"]
        cap, dim = int(meta[0]), int(meta[1])
        if cap != spec.rows or dim != spec.dim:
            raise ValueError(
                f"checkpoint host store is ({cap}, {dim}) but this table's "
                f"spec wants ({spec.rows}, {spec.dim}) — collection changed "
                "since the save?")
        cache_tbl = blob["cache"]["table"]
        if cache_tbl.shape[0] != self.dev_slots:
            raise ValueError(
                f"checkpoint device cache has {cache_tbl.shape[0]} slots but "
                f"this table runs {self.dev_slots} "
                f"(cache_rows={self.cache_rows} + "
                f"bypass_rows={self.bypass_rows}) — rebuild the trainer "
                "with the cache geometry the checkpoint was trained under")
        sblob = blob["store"]
        if ("disk" in sblob) == self._disk:
            # matching store format: a bit-identical tier restore (a
            # store_dtype mismatch re-encodes the blob's fp32 rows)
            if self._disk:
                self.store = TieredHostStore.deserialize(
                    sblob, path=self._disk_path(),
                    store_dtype=spec.store_dtype)
            else:
                self.store = LRUEmbeddingStore.deserialize(
                    sblob, store_dtype=spec.store_dtype)
                self.store.track_recency = False   # backend-owned: see init
        else:
            # cross-format restore: rebuild the configured hierarchy from
            # the blob's logical rows (row-exact, tier residency fresh)
            vec, acc = _store_logical_rows(sblob, spec.rows, spec.dim)
            self.store = self._make_store()
            self.store.preload(np.arange(spec.rows), vec, acc)
        cm = blob["cache_meta"]
        self._reset_slots()
        self._id_for_slot = np.asarray(cm["id_for_slot"], np.int64).copy()
        self._slot_clock = np.asarray(cm["slot_clock"], np.int64).copy()
        scalars = [int(x) for x in np.asarray(cm["scalars"]).reshape(-1)]
        self._tick, self.faults, self.writebacks = scalars[:3]
        # older blobs carry 3 scalars (no hit counter) or 4 (no
        # admit/bypass/promote counters)
        self.hits = scalars[3] if len(scalars) > 3 else 0
        self.admits = scalars[4] if len(scalars) > 4 else 0
        self.bypasses = scalars[5] if len(scalars) > 5 else 0
        self.promotes = scalars[6] if len(scalars) > 6 else 0
        if self._sketch is not None:
            self._sketch = (HotnessSketch.deserialize(cm["hotness"])
                            if "hotness" in cm else HotnessSketch())
        live = np.nonzero(self._id_for_slot >= 0)[0]
        self._slot_for_id = {int(self._id_for_slot[s]): int(s)
                             for s in live.tolist()}
        self._slot_arr[self._id_for_slot[live]] = live.astype(np.int32)
        return {k: np.asarray(v) for k, v in blob["cache"].items()}

    # -- capacity accounting / inspection ------------------------------------

    def host_bytes(self) -> int:
        s = self.store
        if s is None:
            return 0
        if hasattr(s, "host_bytes"):        # tiered: host-tier arrays only
            return s.host_bytes()
        return int(s.payload_bytes() + s.opt_acc.nbytes + s.prev.nbytes
                   + s.next.nbytes + s.keys.nbytes)

    def cache_metrics(self) -> dict:
        """Per-step admission gauges (empty when the sketch is off)."""
        if self._sketch is None:
            return {}
        return {"admit": float(self.last_admit),
                "bypass": float(self.last_bypass),
                "promote": float(self.last_promote)}

    def recency_order(self) -> list[int]:
        """Host-store ids most- to least-recently used (checkpointed)."""
        return self.store.recency_ids()


def _store_logical_rows(sblob, rows: int, dim: int):
    """Host-store checkpoint sub-blob -> dense ``(vec, acc)`` over all
    ``rows`` logical rows (zeros for never-stored ids), from the plain LRU
    blob or the tiered host+disk blob (the disk tier laid down first, then
    the host tier over it: the host copy is the freshest)."""
    vec = np.zeros((rows, dim), np.float32)
    acc = np.zeros((rows,), np.float32)

    def overlay(b):
        meta = np.asarray(b["meta"], np.int64).reshape(-1)
        # plain LRU meta is [capacity, dim, head, tail, size, evictions];
        # the mmap tier's is just [capacity, dim, size]
        size = int(meta[4]) if meta.size > 4 else int(meta[2])
        keys = np.asarray(b["keys"], np.int64)[:size]
        vec[keys] = np.asarray(b["vectors"], np.float32)[:size]
        acc[keys] = np.asarray(b["opt_acc"], np.float32)[:size]

    if "disk" in sblob:
        overlay(sblob["disk"])
        overlay(sblob["host"])
    else:
        overlay(sblob)
    return vec, acc


# ===========================================================================
# ShardedBackend — the sharded embedding-PS router (paper §4.1)
# ===========================================================================

# Knuth's multiplicative-hash constant (2^32 / phi, odd): the routing premix,
# distinct from the in-shard placement shuffle so that shard choice and row
# placement stay decorrelated
_ROUTE_MULT = 2_654_435_761
_ROUTE_ADD = 97_531


class _ShardRouting:
    """Deterministic affine-hash ``id -> (shard, local id)`` routing (the
    JAX package's, in numpy).

    Ids are premixed by a bijective affine map over the padded domain ``P =
    round_up(rows, k)`` (the multiplier moves up by 2 until it is coprime
    with P); then ``shard = premix % k`` and ``local = premix // k``. The
    map is a bijection, so the shards' local id spaces are disjoint and
    exactly invertible: a checkpoint saved with N shards restores row-exactly
    into M."""

    def __init__(self, rows: int, k: int):
        self.rows, self.k = int(rows), int(k)
        P = round_up(max(self.rows, self.k), self.k)
        mult = _ROUTE_MULT
        while math.gcd(mult, P) != 1:
            mult += 2
        self.P, self.mult, self.add = P, mult, _ROUTE_ADD % P
        self.sub_rows = P // self.k          # each shard's local id space

    def shard_and_local(self, ids):
        ids = np.asarray(ids, np.int64)
        pre = (ids * self.mult + self.add) % self.P
        return pre % self.k, pre // self.k


def _dense_state_from_logical(spec: EmbeddingSpec, n_rows: int, vec, acc):
    """A dense PS state (numpy) of ``n_rows`` storage rows holding logical
    row ``i`` of ``vec`` at its uniform-shuffle position: the inverse of
    reading a dense table back row by row. Ids that share a shuffled row
    keep the last one's values, as in the JAX package."""
    pos = PS.shuffle_pos(torch.arange(vec.shape[0]), n_rows).numpy()
    table = np.zeros((n_rows, vec.shape[1]), vec.dtype)
    table[pos] = vec
    state = {"table": table}
    if spec.optimizer == "adagrad":
        a = np.zeros((n_rows,), np.float32)
        if acc is not None:
            a[pos] = np.asarray(acc, np.float32)
        state["acc"] = a
    return state


def extract_logical_rows(blob, spec: EmbeddingSpec, base: str):
    """Checkpoint blob -> ``(vec, acc)`` in logical row order: ``vec[i]`` is
    what a lookup of id ``i`` returns and ``acc[i]`` its accumulator (None
    when the blob has none). Takes every blob geometry: dense (rows read
    back through the uniform shuffle), host_lru (host-store rows overlaid
    with the device cache, whose copies are the freshest) and the router's
    shard-tagged blobs (each shard's blob extracted and scattered back
    through the source routing). This is the reshard path: N-shard
    checkpoints restore row-exactly into M-shard trainers."""
    if isinstance(blob, dict) and "shard_meta" in blob:
        meta = np.asarray(blob["shard_meta"], np.int64).reshape(-1)
        src_k, src_rows = int(meta[0]), int(meta[1])
        if src_rows != spec.rows:
            raise ValueError(
                f"sharded checkpoint holds {src_rows} logical rows but this "
                f"table's spec wants {spec.rows} — collection changed since "
                "the save?")
        routing = _ShardRouting(spec.rows, src_k)
        own, loc = routing.shard_and_local(np.arange(spec.rows))
        sub_spec = dataclasses.replace(spec, rows=routing.sub_rows,
                                       emb_shards=1)
        vec = acc = None
        for s in range(src_k):
            v_s, a_s = extract_logical_rows(blob["shards"][f"s{s}"],
                                            sub_spec, base)
            if vec is None:
                vec = np.zeros((spec.rows, spec.dim), v_s.dtype)
                acc = None if a_s is None \
                    else np.zeros((spec.rows,), np.float32)
            sel = own == s
            vec[sel] = v_s[loc[sel]]
            if acc is not None and a_s is not None:
                acc[sel] = a_s[loc[sel]]
        return vec, acc

    if base == "dense":
        table = blob.get("table") if isinstance(blob, dict) else None
        if table is None:
            raise ValueError(
                "checkpoint blob has no 'table' — it was not written by the "
                "dense backend (restoring across backends is not supported)")
        table = np.asarray(table)
        if table.shape[1] != spec.dim or table.shape[0] < spec.rows:
            raise ValueError(
                f"checkpoint table has shape {tuple(table.shape)} but this "
                f"table's spec wants >= ({spec.rows}, {spec.dim}) — "
                "collection changed since the save?")
        pos = PS.shuffle_pos(torch.arange(spec.rows), table.shape[0]).numpy()
        acc = blob.get("acc")
        return table[pos], (None if acc is None
                            else np.asarray(acc, np.float32)[pos])

    if not isinstance(blob, dict) or "store" not in blob \
            or "cache" not in blob:
        raise ValueError(
            "checkpoint blob has no host store — it was not written by "
            "the host_lru backend (restoring across backends is not "
            "supported)")
    meta = blob["store"]["meta"]
    cap, dim = int(meta[0]), int(meta[1])
    if cap != spec.rows or dim != spec.dim:
        raise ValueError(
            f"checkpoint host store is ({cap}, {dim}) but this table's "
            f"spec wants ({spec.rows}, {spec.dim}) — collection changed "
            "since the save?")
    vec, acc = _store_logical_rows(blob["store"], spec.rows, spec.dim)
    # the device cache holds the freshest copy of every resident row: lay
    # it over the store, as draining the cache would
    id_for_slot = np.asarray(blob["cache_meta"]["id_for_slot"], np.int64)
    live = np.nonzero(id_for_slot >= 0)[0]
    if live.size:
        cached = id_for_slot[live]
        vec[cached] = np.asarray(blob["cache"]["table"], np.float32)[live]
        if "acc" in blob["cache"]:
            acc[cached] = np.asarray(blob["cache"]["acc"], np.float32)[live]
    return vec, acc


class ShardedBackend(EmbeddingBackend):
    """Router over ``n_shards`` independent shard backends: the embedding
    PS as a set of shards (paper §4.1: capacity and host fault-in
    bandwidth grow with the number of shards).

    Each shard is a full dense or host_lru backend over its own local id
    space (disjoint under the bijective :class:`_ShardRouting`), with its
    own lock, slot map, host store and staleness queue. ``prepare`` routes
    the batch and runs the host_lru shards' fault-ins concurrently on a
    thread pool (``emb-shard`` threads), each under its own shard's lock;
    they upload and ``index_copy_`` on the default stream, and no pool
    thread launches a kernel of the port.

    Device ids are shard-encoded: ``dev = shard * stride + local`` with
    one ``stride`` (a host_lru shard's slot pool, cache and bypass, or a
    dense shard's rows). State and queues are dicts keyed ``"s0" ..
    "s{k-1}"``; every shard's queue is as wide as the router's unique put,
    which it holds masked to the shard's own ids.

    The device side keeps each stage's launches: a lookup or serve read
    gathers every shard's owned unique rows into ONE (U, dim) block by
    index, which the stage's bag launch pools with the identity for
    ``dev``; a put segment-sums its occurrence gradients ONCE (a sum-only
    ``fused_backward`` launch) and hands the sums to every shard's put
    (one apply-only launch each). Checkpoints are shard-tagged
    (``shard_meta`` and one blob per shard); a restore into another shard
    count reshards row-exactly through :func:`extract_logical_rows`, with
    caches restarted and the queued puts dropped (the paper's tolerated
    in-flight loss).

    Under a mesh a shard's state is row-sharded as a table of its own (a
    dense shard's rows padded to the ranks that shard it), a plan carries
    no :class:`~repro_torch.core.dedup.ShardParts` but the logical ids
    (``kind="ids"``): a lookup reads every shard's rows through one mesh
    lookup (:meth:`_mesh_lookup`; a serve read shard by shard through
    :func:`_mesh_rows`), a put sums once and hands each shard its share
    (:meth:`_mesh_unique`: the shards' popped puts gathered together),
    and the host_lru shards prepare in shard order on the calling
    thread."""

    # the in-process router needs >= 2 shards (one shard IS the plain
    # backend); a router whose shards live in other processes allows 1
    min_shards = 2

    def __init__(self, spec: EmbeddingSpec, n_shards: int | None = None):
        base, _ = parse_backend_name(spec.backend)
        if base.startswith("host_lru") and spec.cache_rows <= 0:
            raise ValueError(
                "host_lru backend needs EmbeddingSpec.cache_rows > 0 "
                f"(got {spec.cache_rows})")
        self.spec = spec
        self._base = base
        self._host = base.startswith("host_lru")
        self._lock = threading.Lock()        # the traffic counters only
        self._pool: ThreadPoolExecutor | None = None
        self._configure(int(n_shards if n_shards is not None
                            else spec.emb_shards))

    def _make_sub(self, s: int, sub_spec: EmbeddingSpec) -> EmbeddingBackend:
        """Shard ``s``'s backend: the hook a router whose shards live in
        other processes overrides."""
        return HostLRUBackend(sub_spec) if self._host \
            else DenseBackend(sub_spec)

    def _configure(self, k: int):
        if k < self.min_shards:
            raise ValueError(
                f"{type(self).__name__} needs >= {self.min_shards} shards "
                f"(got {k}); use the plain backend for a single shard")
        spec = self.spec
        self.n_shards = k
        self._routing = _ShardRouting(spec.rows, k)
        kw = {"backend": self._base, "emb_shards": 1,
              "rows": self._routing.sub_rows}
        if self._host:
            # cache_rows stays the table's TOTAL device-cache budget, split
            # evenly over the shards (by ceiling), as are the bypass
            # region, the +disk host tier and the mmap directory
            kw["cache_rows"] = -(-spec.cache_rows // k)
            if spec.bypass_rows:
                kw["bypass_rows"] = -(-int(spec.bypass_rows) // k)
            if spec.host_rows:
                kw["host_rows"] = -(-int(spec.host_rows) // k)
        subs = []
        for s in range(k):
            kws = dict(kw)
            if self._host and spec.disk_path is not None:
                kws["disk_path"] = os.path.join(spec.disk_path, f"s{s}")
            subs.append(self._make_sub(s, dataclasses.replace(spec, **kws)))
        self.shard_backends = subs
        # a host_lru shard's local device ids span its whole slot pool
        # (cache and bypass), a dense shard's its rows
        self.stride = subs[0].dev_slots if self._host \
            else self._routing.sub_rows
        self._traffic = np.zeros(k, np.int64)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.n_shards, thread_name_prefix="emb-shard")
            return self._pool

    def state_device(self, state) -> torch.device:
        return state["s0"]["table"].device

    # -- host-level ----------------------------------------------------------

    def init(self, generator: torch.Generator, shards: int = 1,
             scale: float = 0.02):
        """Draw the table one shard would draw from ``generator`` (on its
        device), read its logical rows (row ``i`` is what a one-shard
        lookup of ``i`` reads) and distribute them over the shards: the
        router is bit-exact with the plain backend. ``shards=1`` keeps the
        configured count; another count reconfigures the router first."""
        if shards not in (1, self.n_shards):
            self._configure(int(shards))
        spec = self.spec
        ref_spec = dataclasses.replace(spec, backend="dense", emb_shards=1)
        table = PS.ps_init(generator, ref_spec, 1, scale)["table"]
        pos = PS.shuffle_pos(torch.arange(spec.rows), spec.padded_rows(1))
        vec = table.float().cpu().numpy()[pos.numpy()]
        del table
        self._traffic = np.zeros(self.n_shards, np.int64)
        return self._sub_states_from_logical(vec, None, generator.device)

    def _sub_states_from_logical(self, vec, acc, device=None):
        """Logical rows (and accumulators) distributed over the shards by
        the routing: the init and reshard path. With ``device`` the
        states are tensors there, else numpy (a restore's)."""
        r = self._routing
        ids = np.arange(self.spec.rows)
        own, loc = r.shard_and_local(ids)
        states = {}
        for s, sub in enumerate(self.shard_backends):
            sel = own == s
            gl, ll = ids[sel], loc[sel]
            if self._host:
                st = sub._init_with_rows(
                    ll, np.asarray(vec[gl], np.float32),
                    None if acc is None else acc[gl],
                    device="cpu" if device is None else device)
                if device is None:
                    st = {k: v.numpy() for k, v in st.items()}
            else:
                sub_vec = np.zeros((r.sub_rows, vec.shape[1]), vec.dtype)
                sub_vec[ll] = vec[gl]
                sub_acc = None
                if acc is not None:
                    sub_acc = np.zeros((r.sub_rows,), np.float32)
                    sub_acc[ll] = acc[gl]
                # under a mesh a shard's rows pad to the ranks sharding it
                st = _dense_state_from_logical(
                    sub.spec, sub.spec.padded_rows(PS.n_shards(sub.spec)),
                    sub_vec, sub_acc)
                if device is not None:
                    st = {k: torch.from_numpy(v).to(device).to(
                        sub.spec.dtype if k == "table" else torch.float32)
                        for k, v in st.items()}
            states[f"s{s}"] = st
        return states

    def dedup_rows(self) -> int:
        return min(self.spec.rows, self.dev_rows())

    def dev_rows(self) -> int:
        return self.n_shards * self.stride

    def _route(self, flat: np.ndarray):
        """Logical ids -> (owner shard, -1 for invalid ids; local id)."""
        valid = (flat >= 0) & (flat < self.spec.rows)
        own, loc = self._routing.shard_and_local(np.where(valid, flat, 0))
        return np.where(valid, own, -1), loc

    def prepare(self, state, ids, assume_unique: bool = False, counts=None):
        return self.prepare_submit(state, ids, assume_unique, counts)()

    def prepare_submit(self, state, ids, assume_unique: bool = False,
                       counts=None):
        """Route the batch and submit every shard's prepare on its local
        ids (a remote shard buffers one coalesced RPC into its endpoint's
        frame, an in-process shard defers the work); the returned thunk
        collects them, the host_lru shards' fault-ins concurrently on the
        router's pool, each under its shard's lock -> ``(state,
        shard-encoded device ids)``, as host int32 for host ids or as a
        tensor on the table's device for a tensor. With a plan's unique
        ids (``assume_unique``), ``counts`` carries their occurrence
        counts, so the traffic and imbalance gauges count the raw id
        stream, hot keys included."""
        arr = _host_ids(ids)
        flat = arr.reshape(-1)
        own, loc = self._route(flat)
        with self._lock:
            if counts is None:
                self._traffic += np.bincount(own[own >= 0],
                                             minlength=self.n_shards)
            else:
                c = np.asarray(counts, np.int64).reshape(-1)
                np.add.at(self._traffic, own[own >= 0], c[own >= 0])
        # counts stay aligned by position: the ids other shards own are -1
        # in a shard's batch
        thunks = [self.shard_backends[s].prepare_submit(
            state[f"s{s}"], np.where(own == s, loc, -1), assume_unique,
            counts) for s in range(self.n_shards)] if self._host else []

        def collect():
            new_state = dict(state)
            if self._host:
                device = self.state_device(state)

                def one(t):
                    with (torch.cuda.device(device) if device.type == "cuda"
                          else contextlib.nullcontext()):
                        return t()

                if _on_mesh():
                    # an eviction under a mesh gathers rows over the mesh:
                    # the shards prepare in shard order, on this thread
                    got = [t() for t in thunks]
                else:
                    pool = self._ensure_pool()
                    got = [f.result() for f in
                           [pool.submit(one, t) for t in thunks]]
                devs = np.empty((self.n_shards, flat.size), np.int64)
                for s, (st_s, dev_s) in enumerate(got):
                    new_state[f"s{s}"] = st_s
                    devs[s] = np.asarray(dev_s, np.int64).reshape(-1)
                local = devs[np.maximum(own, 0), np.arange(flat.size)]
            else:
                local = loc                 # a dense shard's ids are its own
            out = np.where((own >= 0) & (local >= 0),
                           own * self.stride + local,
                           -1).astype(np.int32).reshape(arr.shape)
            if isinstance(ids, torch.Tensor):
                return new_state, torch.from_numpy(out).to(
                    self.state_device(state))
            return new_state, out
        return collect

    def plan_parts(self, dev_u: np.ndarray) -> list[np.ndarray]:
        """The host int32 arrays of a plan's :class:`~repro_torch.core.
        dedup.ShardParts`, from its shard-encoded unique device ids:
        ``[perm, rows_0 .. rows_{k-1}, local_0 .. local_{k-1}]``."""
        dev = np.asarray(dev_u, np.int64).reshape(-1)
        ok = (dev >= 0) & (dev < self.dev_rows())
        own = np.where(ok, dev // self.stride, -1)
        loc = np.where(ok, dev % self.stride, -1)
        perm = np.empty(dev.size, np.int32)
        rows, local, off = [], [], 0
        for s, sub in enumerate(self.shard_backends):
            sel = np.nonzero(own == s)[0]
            rows.append(sub.table_rows(torch.from_numpy(loc[sel])).numpy())
            perm[sel] = off + np.arange(sel.size)
            off += sel.size
            local.append(np.where(own == s, loc, -1).astype(np.int32))
        perm[~ok] = off                     # the zero row after the gathers
        return [perm, *rows, *local]

    # -- serve-path read (read-only) -----------------------------------------

    @contextlib.contextmanager
    def _all_locks(self):
        with contextlib.ExitStack() as held:
            for sub in self.shard_backends:
                held.enter_context(sub.read_lock())
            yield

    def read_lock(self):
        return self._all_locks()

    def _read_begin(self, arr, occ=False):
        """Route the read's unique ids and resolve each shard's residency:
        the arrays to upload are the occurrence inverse, each shard's
        positions and table rows of its resident ids and the positions of
        the rows read from a host tier; the rows to upload are those. Call
        under :meth:`read_lock` with the matching :meth:`_read_end`."""
        flat = arr.reshape(-1)
        valid = (flat >= 0) & (flat < self.spec.rows)
        uniq, inv_valid = np.unique(flat[valid], return_inverse=True)
        inv = np.full(flat.shape, -1, np.int32)
        inv[valid] = inv_valid
        own, loc = self._route(uniq)
        idx, miss_pos, miss_vecs = [inv.reshape(arr.shape)], [], []
        hits = 0
        # under a mesh each shard's rows are read through the mesh lookup
        # at one width on every rank (the block's size); the padding
        # reads zeros into the row after the read's own
        width = max(flat.size, 1) if _on_mesh() else None
        for s, sub in enumerate(self.shard_backends):
            pos = np.nonzero(own == s)[0]
            hit, rows, vecs = sub._resolve_unique(loc[pos])
            if width is None:
                idx += [pos[hit].astype(np.int32), rows]
            else:
                idx += [_pad_to(pos[hit].astype(np.int32), width, flat.size),
                        _pad_to(np.asarray(rows, np.int32), width)]
            miss_pos.append(pos[~hit])
            miss_vecs.append(vecs)
            hits += int(hit.sum())
        idx.append(np.concatenate(miss_pos).astype(np.int32))
        vecs = np.concatenate(miss_vecs) if self._host else None
        return idx, vecs, {"reads": int(uniq.size), "hits": hits,
                           "misses": int(uniq.size) - hits}

    def _read_end(self, state, idx, rows, occ=False):
        """The read's unique rows gathered into one block by index (each
        shard's resident rows, then the rows from the host tiers; at least
        one row, so an empty read still pools zeros)."""
        inv, parts, miss_pos = idx[0], idx[1:-1], idx[-1]
        tables = [state[f"s{s}"]["table"] for s in range(self.n_shards)]
        mesh = _on_mesh()
        U = int(inv.numel()) + 1 if mesh else \
            sum(int(p.shape[0]) for p in parts[::2]) + int(miss_pos.shape[0])
        block = torch.zeros((max(U, 1), self.spec.dim),
                            dtype=torch.float32, device=tables[0].device)
        for s, (t, pos, r) in enumerate(zip(tables, parts[::2],
                                            parts[1::2])):
            got = _mesh_rows(self.shard_backends[s], state[f"s{s}"], r) \
                if mesh else t.index_select(0, r.long()).float()
            block.index_copy_(0, pos.long(), got)
        if rows is not None:
            block.index_copy_(0, miss_pos.long(), rows)
        if occ:
            return D.plan_scatter(block, inv)
        return (block, None, inv, False)

    # -- slot pinning / shard introspection ----------------------------------

    def _split_dev(self, dev_ids):
        host = dev_ids.host if D.is_plan(dev_ids) else None
        flat = _host_ids(D.plan_dev(dev_ids) if host is None
                         else host).reshape(-1)
        flat = flat[(flat >= 0) & (flat < self.dev_rows())]
        return flat // self.stride, flat % self.stride

    def pin_slots(self, dev_ids):
        own, loc = self._split_dev(dev_ids)
        for s, sub in enumerate(self.shard_backends):
            sel = own == s
            if sel.any():
                sub.pin_slots(loc[sel])

    def unpin_slots(self, dev_ids):
        own, loc = self._split_dev(dev_ids)
        for s, sub in enumerate(self.shard_backends):
            sel = own == s
            if sel.any():
                sub.unpin_slots(loc[sel])

    def reset_pins(self):
        for sub in self.shard_backends:
            sub.reset_pins()

    def n_put_shards(self) -> int:
        return self.n_shards

    def put_shards(self, dev_ids) -> tuple[int, ...]:
        own, _ = self._split_dev(dev_ids)
        return tuple(np.unique(own).tolist())

    def queue_init(self, ids_shape, device=None):
        if self.spec.staleness <= 0:
            return None
        # every shard's queue at the ROUTER's width: the unique put is
        # pushed into each shard masked to the shard's rows
        return self._queue_init_width(self.queue_width(_prod(ids_shape)),
                                      device)

    def _queue_init_width(self, width: int, device=None):
        return {f"s{s}": sub._queue_init_width(width, device)
                for s, sub in enumerate(self.shard_backends)}

    # -- device-side ---------------------------------------------------------

    def _local_ids(self, flat: torch.Tensor, s: int) -> torch.Tensor:
        local = flat - s * self.stride
        return torch.where((local >= 0) & (local < self.stride), local, -1)

    def _locals(self, dev_u: torch.Tensor, plan=None) -> list:
        """Every shard's local ids of unique device ids (-1 where another
        shard owns the id): the plan's uploaded ones when it has them."""
        if plan is not None and plan.shards is not None:
            return list(plan.shards.local)
        return [self._local_ids(dev_u, s) for s in range(self.n_shards)]

    def _lookup_flat(self, state, dev_ids):
        """Occurrence rows: each shard's rows selected where it owns the
        id (zeros where none does); under a mesh, row-sharded shards
        through one mesh lookup (:meth:`_mesh_lookup`)."""
        shape = dev_ids.shape
        flat = dev_ids.reshape(-1)
        if _on_mesh() and not self.remote and self._shards_split():
            return self._mesh_lookup(state, flat).reshape(
                *shape, self.spec.dim), {}
        out = None
        for s, sub in enumerate(self.shard_backends):
            local = self._local_ids(flat, s)
            acts, _ = sub._lookup_flat(state[f"s{s}"], local)
            out = acts if out is None else \
                torch.where((local >= 0)[:, None], acts, out)
        return out.reshape(*shape, self.spec.dim), {}

    def _plan_unique(self, state, plan):
        """A plan's (U, dim) unique rows in ONE block: every shard's rows
        gathered, then put at their plan positions by one gather through
        ``perm`` (padding reads a zero row)."""
        parts = plan.shards
        if parts is None:
            return self._lookup_unique(state, plan.dev)
        gathered = [state[f"s{s}"]["table"].index_select(0, r)
                    for s, r in enumerate(parts.rows)]
        gathered.append(gathered[0].new_zeros((1, self.spec.dim)))
        return torch.cat(gathered).index_select(0, parts.perm), {}

    def _bag_entry(self, state, dev_ids) -> tuple:
        if D.is_plan(dev_ids):
            return (self._plan_unique(state, dev_ids)[0], None, dev_ids.inv,
                    False)
        rows, _ = self._lookup_flat(state, dev_ids)
        return (rows.reshape(-1, self.spec.dim), None, _slots(dev_ids), True)

    def lookup_pooled(self, state, dev_ids):
        return _bag_all({0: self._bag_entry(state, dev_ids)})[0], {}

    def _put_plan(self, state, plan, grads):
        if _on_mesh():
            st, _, m = self._mesh_unique(state, None, plan.dev, plan.ids,
                                         _plan_sums(plan, grads))
            return st, m
        return self._put_unique(state, plan.dev, _plan_sums(plan, grads),
                                self._locals(plan.dev, plan))

    def _hybrid_plan(self, state, queue, plan, grads):
        if _on_mesh():
            return self._mesh_unique(state, queue, plan.dev, plan.ids,
                                     _plan_sums(plan, grads))
        return self._hybrid_unique(state, queue, plan.dev,
                                   _plan_sums(plan, grads),
                                   self._locals(plan.dev, plan))

    def _route_t(self, ids: torch.Tensor):
        """:meth:`_route` of a tensor of logical ids, on its device:
        (owner shard, -1 for invalid ids; local id, -1 there)."""
        r = self._routing
        ids = ids.long()
        valid = (ids >= 0) & (ids < self.spec.rows)
        pre = (torch.where(valid, ids, 0) * r.mult + r.add) % r.P
        return (torch.where(valid, pre % self.n_shards, -1),
                torch.where(valid, pre // self.n_shards, -1))

    def _mesh_unique(self, state, queue, dev_u, ids_u, g_u):
        """Under a mesh, every shard's share of a put that is unique over
        the global batch (shard-encoded device ids, logical ids, fp32
        sums), in shard order on every rank: each shard pushes its own
        entries (its local device and logical ids, -1 where another shard
        owns the id) and applies the put that pops out as the mesh applies
        one. The shards' popped entries travel together: one all_gather of
        every shard's table rows (and a host_lru shard's logical ids) and
        one of their grads, then each shard applies its own rows
        (``embedding_ps.apply_gathered``, ``_mesh_apply_gathered``), as
        each one's ``_mesh_unique`` would on its own. A table in model
        mode puts shard by shard."""
        _, loc = self._route_t(ids_u)
        own = torch.where(dev_u >= 0, dev_u // self.stride, -1)
        subs = self.shard_backends
        new_state, new_queue = dict(state), dict(queue or {})
        if self.spec.mode == "model":
            for s, sub in enumerate(subs):
                mine = own == s
                q = None if queue is None else queue.get(f"s{s}")
                new_state[f"s{s}"], new_queue[f"s{s}"], _ = sub._mesh_unique(
                    state[f"s{s}"], q,
                    torch.where(mine, dev_u - s * self.stride, -1),
                    torch.where(mine, loc, -1), g_u)
            return new_state, None if queue is None else new_queue, {}
        keys, ids, grads = [], [], []
        for s, sub in enumerate(subs):
            mine = own == s
            k = torch.where(mine, dev_u - s * self.stride, -1) \
                .to(torch.int32)
            i = torch.where(mine, loc, -1).to(torch.int32)
            g = g_u
            q = None if queue is None else queue.get(f"s{s}")
            if q is not None:
                cap = int(q["ids"].shape[1])
                k, i, g = (D.pad_axis0(k, cap, -1), D.pad_axis0(i, cap, -1),
                           D.pad_axis0(g_u, cap, 0))
                if self._host:
                    q, k, i, g = sub._queue_push_pop(q, k, i, g)
                else:
                    q, i, g = PS.queue_push_pop(q, i, g)
                    k = i
                new_queue[f"s{s}"] = q
            keys.append(sub.table_rows(k))
            ids.append(i.to(torch.int32))
            grads.append(g.float())
        # the popped puts' ids are checked against a host_lru shard's
        # slots (a sync put's are this step's own)
        check = self._host and queue is not None
        axes = PS._axes_for(self.spec.mode)[1]
        k_all = all_gather(torch.stack(keys + ids if check else keys)
                           .contiguous(), axes)
        g_all = all_gather(torch.stack(grads).contiguous(), axes)
        nb, k = axis_size(axes), len(subs)
        k_all = k_all.view(nb, -1, k_all.shape[-1])
        g_all = g_all.view(nb, k, *g_all.shape[1:])
        for s, sub in enumerate(subs):
            rows, g = k_all[:, s].reshape(-1), g_all[:, s].reshape(
                -1, g_all.shape[-1])
            if self._host:
                i = k_all[:, k + s].reshape(-1) if check else None
                new_state[f"s{s}"] = sub._mesh_apply_gathered(
                    state[f"s{s}"], rows, i, g)
            else:
                new_state[f"s{s}"] = PS.apply_gathered(
                    state[f"s{s}"], sub.spec, rows, g)
        return new_state, None if queue is None else new_queue, {}

    def _mesh_lookup(self, state, flat: torch.Tensor) -> torch.Tensor:
        """Under a mesh, the rows of (T,) shard-encoded device ids when
        every shard's state is row-sharded: one mesh lookup for all the
        shards (the ids gathered over the batch axes in full mode, each
        rank's own rows of every shard read, one sum over the shard axes;
        each row one owner's value plus zeros: exact), as each shard's
        ``_lookup_flat`` reads its own."""
        shard_axes, batch = PS._axes_for(self.spec.mode)
        full = self.spec.mode != "model"
        flat = flat.to(torch.int32).contiguous()
        dev_all = all_gather(flat, batch) if full else flat
        me = flat_index(shard_axes)
        vals = None
        for s, sub in enumerate(self.shard_backends):
            table = state[f"s{s}"]["table"]
            rows = sub.table_rows(self._local_ids(dev_all, s))
            rl = int(table.shape[0])
            mine = (rows >= 0) & (rows // rl == me)
            got = table[torch.where(mine, rows % rl, 0).long()]
            vals = torch.where(mine[:, None], got,
                               0 if vals is None else vals)
        vals = vals.contiguous()
        psum(vals, shard_axes)
        if full and batch:
            t = int(flat.shape[0])
            vals = vals[flat_index(batch) * t:][:t]
        return vals

    def _shards_split(self) -> bool:
        """Under a mesh, every shard's state row-sharded over the mesh
        (a dense shard's always; a host_lru shard's where its slots divide
        the ranks)."""
        return all(sub._cache_split()[0] > 1
                   if isinstance(sub, HostLRUBackend)
                   else PS.n_shards(sub.spec) > 1
                   for sub in self.shard_backends)

    def _wire_begin(self, state, queue, plan, grads):
        if _on_mesh():
            return _wire_begin_mesh(self, state, queue, plan, grads)
        g_u = _plan_sums(plan, grads)

        def finish():
            return self._hybrid_unique(state, queue, plan.dev, g_u,
                                       self._locals(plan.dev, plan))
        return g_u, finish

    def _put_flat(self, state, dev_ids, grads):
        flat = dev_ids.reshape(-1)
        g = grads.reshape(-1, self.spec.dim)
        new = dict(state)
        for s, sub in enumerate(self.shard_backends):
            new[f"s{s}"], _ = sub._put_flat(state[f"s{s}"],
                                            self._local_ids(flat, s), g)
        return new, {}

    def _put_unique(self, state, dev_u, g_u, local=None):
        local = local or self._locals(dev_u)
        new = dict(state)
        for s, sub in enumerate(self.shard_backends):
            new[f"s{s}"], _ = sub._put_unique(state[f"s{s}"], local[s], g_u)
        return new, {}

    def _per_shard_hybrid(self, state, queue, fn):
        new_state, new_queue = dict(state), dict(queue or {})
        for s in range(self.n_shards):
            q = None if queue is None else queue.get(f"s{s}")
            new_state[f"s{s}"], new_queue[f"s{s}"], _ = fn(s, state[f"s{s}"],
                                                           q)
        if queue is None and all(v is None for v in new_queue.values()):
            return new_state, None, {}
        return new_state, new_queue, {}

    def _hybrid_flat(self, state, queue, dev_ids, grads):
        flat = dev_ids.reshape(-1)
        g = grads.reshape(-1, self.spec.dim)
        return self._per_shard_hybrid(
            state, queue, lambda s, st, q: self.shard_backends[s]._hybrid_flat(
                st, q, self._local_ids(flat, s), g))

    def _hybrid_unique(self, state, queue, dev_u, g_u, local=None):
        local = local or self._locals(dev_u)
        return self._per_shard_hybrid(
            state, queue,
            lambda s, st, q: self.shard_backends[s]._hybrid_unique(
                st, q, local[s], g_u))

    # -- checkpoint ----------------------------------------------------------

    def state_for_checkpoint(self, state):
        return {
            "shard_meta": np.array([self.n_shards, self.spec.rows,
                                    self.spec.dim], np.int64),
            "shards": {f"s{s}": sub.state_for_checkpoint(state[f"s{s}"])
                       for s, sub in enumerate(self.shard_backends)},
        }

    def restore_from_checkpoint(self, blob):
        """A blob of this shard count restores shard by shard, bit for bit;
        any other blob (another shard count, or a plain backend's) is
        resharded from its logical rows (``last_restore_resharded``).
        Returns the shards' states as numpy."""
        self.last_restore_resharded = False
        if isinstance(blob, dict) and "shard_meta" in blob:
            meta = np.asarray(blob["shard_meta"], np.int64).reshape(-1)
            if int(meta[0]) == self.n_shards:
                out = {}
                for s, sub in enumerate(self.shard_backends):
                    try:
                        out[f"s{s}"] = sub.restore_from_checkpoint(
                            blob["shards"][f"s{s}"])
                    except ValueError as e:
                        raise ValueError(f"shard {s}: {e}") from e
                return out
        vec, acc = extract_logical_rows(blob, self.spec, self._base)
        self.last_restore_resharded = True
        return self._sub_states_from_logical(vec, acc)

    # -- metrics / capacity accounting ---------------------------------------

    def shard_metrics(self) -> dict:
        """Per-shard gauges (keys relative: the trainer prefixes
        ``shard/<table>/``): hit rate, faults, rows and bytes, plus
        ``imbalance``, the max/mean of the cumulative routed-id traffic
        (hot-key skew made visible)."""
        out = {}
        for s, sub in enumerate(self.shard_backends):
            faults = getattr(sub, "faults", 0)
            hits = getattr(sub, "hits", 0)
            looked = hits + faults
            out[f"{s}/hit_rate"] = (hits / looked) if looked else 1.0
            out[f"{s}/faults"] = float(faults)
            store = getattr(sub, "store", None)
            if store is not None:
                out[f"{s}/rows"] = float(store.size)
                out[f"{s}/bytes"] = float(sub.host_bytes())
            else:
                itemsize = torch.empty((), dtype=sub.spec.dtype) \
                    .element_size()
                out[f"{s}/rows"] = float(sub.spec.rows)
                out[f"{s}/bytes"] = float(sub.spec.rows * sub.spec.dim
                                          * itemsize)
        with self._lock:
            traffic = self._traffic.copy()
        mean = float(traffic.mean()) if traffic.size else 0.0
        out["imbalance"] = (float(traffic.max()) / mean) if mean > 0 else 1.0
        return out

    def cache_metrics(self) -> dict:
        out: dict[str, float] = {}
        for sub in self.shard_backends:
            for k, v in sub.cache_metrics().items():
                out[k] = out.get(k, 0.0) + v
        return out

    def device_bytes(self, state) -> int:
        return sum(sub.device_bytes(state[f"s{s}"])
                   for s, sub in enumerate(self.shard_backends))

    def host_bytes(self) -> int:
        return sum(sub.host_bytes() for sub in self.shard_backends)


class CompressedWireBackend(EmbeddingBackend):
    """The paper's §4.2.3 communication compression, as a decorator over
    either storage backend: gradient puts are deduplicated to one row per
    unique id (lossless), and both get and put payloads cross the wire as
    blockscale fp16 (lossy), through the ``blockscale_compress`` and
    ``blockscale_decompress`` CUDA kernels (their plain versions on the
    CPU). Per-step bytes-moved metrics surface through the trainer's
    metrics as ``wire/<table>/{get,put}_bytes_{raw,wire}``, computed from
    host counts (a put of occurrence-width ids, grouped on the device,
    reports its unique count as a device scalar, without a sync).

    The codec's blocks run across rows: with a plan the get roundtrips the
    (U, dim) unique rows, otherwise the occurrence rows, as in the JAX
    package; both agree only when ``dim`` is a multiple of the block."""

    def __init__(self, inner: EmbeddingBackend):
        self.inner = inner
        self.spec = inner.spec
        self._block = int(self.spec.wire_block)
        if self.spec.wire_kernel and self._block != 128:
            raise ValueError("the Pallas blockscale kernel is fixed at "
                             f"block=128 (got wire_block={self._block})")

    def _roundtrip(self, v: torch.Tensor) -> torch.Tensor:
        return K.blockscale_roundtrip(v.contiguous(), block=self._block)

    def _get_metrics(self, n_raw: int, n_wire: int) -> dict:
        blocks = -(-n_wire // self._block)
        return {"get_bytes_raw": float(n_raw * 4),
                "get_bytes_wire": float(blocks * self._block * 2
                                        + blocks * 4)}

    # -- host-level: delegate ------------------------------------------------

    def init(self, generator: torch.Generator, shards: int = 1,
             scale: float = 0.02):
        return self.inner.init(generator, shards, scale)

    def prepare(self, state, ids, assume_unique: bool = False, counts=None):
        return self.inner.prepare(state, ids, assume_unique, counts)

    def read_rows(self, state, ids):
        # serve reads cross the same lossy wire as training lookups
        rows, info = self.inner.read_rows(state, ids)
        return self._roundtrip(rows), info

    def read_pooled(self, state, ids):
        rows, info = self.read_rows(state, ids)
        return _pool_rows(rows, torch.as_tensor(_host_ids(ids),
                                                device=rows.device)), info

    def dedup_rows(self) -> int:
        return self.inner.dedup_rows()

    def dev_rows(self) -> int:
        return self.inner.dev_rows()

    def queue_width(self, n_occ: int) -> int:
        # the wire ALWAYS dedups its puts (even at occurrence width), so its
        # queue is capped whatever batch_dedup says, over the device ids
        return D.dedup_cap(n_occ, self.dev_rows())

    def read_lock(self):
        return self.inner.read_lock()

    def pin_slots(self, dev_ids):
        self.inner.pin_slots(dev_ids)

    def unpin_slots(self, dev_ids):
        self.inner.unpin_slots(dev_ids)

    def reset_pins(self):
        self.inner.reset_pins()

    def n_put_shards(self) -> int:
        return self.inner.n_put_shards()

    def put_shards(self, dev_ids) -> tuple[int, ...]:
        return self.inner.put_shards(dev_ids)

    def shard_metrics(self) -> dict:
        return self.inner.shard_metrics()

    def cache_metrics(self) -> dict:
        return self.inner.cache_metrics()

    @property
    def last_restore_resharded(self) -> bool:
        return self.inner.last_restore_resharded

    def state_device(self, state) -> torch.device:
        return self.inner.state_device(state)

    def state_for_checkpoint(self, state):
        return self.inner.state_for_checkpoint(state)

    def restore_from_checkpoint(self, blob):
        return self.inner.restore_from_checkpoint(blob)

    def device_bytes(self, state) -> int:
        return self.inner.device_bytes(state)

    def host_bytes(self) -> int:
        return self.inner.host_bytes()

    def queue_init(self, ids_shape, device=None):
        # the queue lives PS-side, AFTER the wire: it holds deduped puts
        if self.spec.staleness <= 0:
            return None
        return self.inner._queue_init_width(
            self.queue_width(_prod(ids_shape)), device)

    # -- device-side ---------------------------------------------------------

    def _get_rows(self, state, dev_ids):
        """The get up to the wire: the rows that cross it (contiguous, to
        be compressed by the caller), with the get's byte metrics -> ``(rows,
        metrics)``. One row per unique id for a plan (the inverse scatter
        to occurrence width happens after the wire, so the bytes shrink by
        the batch's dup factor), else one per occurrence."""
        if D.is_plan(dev_ids):
            rows, m = self.inner._plan_unique(state, dev_ids)
            n_raw = dev_ids.inv.numel() * self.spec.dim
        else:
            rows, m = self.inner.lookup(state, dev_ids)
            n_raw = rows.numel()
        return rows.contiguous(), {
            **m, **self._get_metrics(n_raw, rows.numel())}

    def _get(self, state, dev_ids):
        """The rows that cross the wire, roundtripped, with the get's byte
        metrics."""
        rows, m = self._get_rows(state, dev_ids)
        return self._roundtrip(rows), m

    def lookup(self, state, dev_ids):
        rows, m = self._get(state, dev_ids)
        if D.is_plan(dev_ids):
            return D.plan_scatter(rows, dev_ids.inv), m
        return rows, m

    def lookup_pooled(self, state, dev_ids):
        rows, m = self._get(state, dev_ids)
        if not D.is_plan(dev_ids):
            return _pool_rows(rows, dev_ids), m
        slots = torch.arange(rows.shape[0], dtype=torch.int32,
                             device=rows.device)
        return K.unique_bag(rows, slots, dev_ids.inv), m

    def _compress_put(self, dev_ids):
        """dev_ids (plan | occurrence ids) -> (the put's dedup plan, byte
        metrics). With a plan the lossless dedup IS the plan; occurrence
        ids are grouped on the device (``compression.dedup_plan``)."""
        spec = self.spec
        if D.is_plan(dev_ids):
            plan, n_put = dev_ids, int(dev_ids.inv.numel())
            n_uniq = plan.n_unique if plan.n_unique is not None \
                else int((plan.dev >= 0).sum())
            n_vals = n_uniq * spec.dim
            blocks = -(-n_vals // self._block)
        else:
            flat = dev_ids.reshape(-1)
            n_put = int(flat.numel())
            plan = C.dedup_plan(flat, D.dedup_cap(n_put, self.dev_rows()))
            n_uniq = (plan.dev >= 0).sum().float()
            n_vals = n_uniq * spec.dim
            blocks = torch.ceil(n_vals / self._block)
        return plan, {
            # raw wire: one (int32 id, fp32 row) per put entry, pre-dedup
            "put_bytes_raw": float(n_put * (4 + spec.dim * 4)),
            # compressed wire: unique ids + fp16 values + per-block scales
            "put_bytes_wire": n_uniq * 4 + n_vals * 2 + blocks * 4,
        }

    def apply_put(self, state, dev_ids, grads):
        st, _, m = _wire_puts([(self, state, None, dev_ids, grads)])[0]
        return st, m

    def hybrid_update(self, state, queue, dev_ids, grads):
        return _wire_puts([(self, state, queue, dev_ids, grads)])[0]


def _wire_puts(items) -> list:
    """The puts of tables behind the wire, ``items`` of (backend, state,
    queue, dev_ids, grads), run in phases so that the codec is one launch
    each for all of them: (1) every table's segment sums (fused with the
    popped put's apply in hybrid mode, a sum-only launch in sync mode);
    (2) ONE compress of all the payloads; (3) ONE decompress of them,
    written back into them in place; (4) every table's queue write (sync:
    its apply-only launch). Returns [(state, queue, metrics)]."""
    begun = []
    for b, state, queue, dev_ids, grads in items:
        plan, m = b._compress_put(dev_ids)
        payload, finish = b.inner._wire_begin(state, queue, plan, grads)
        begun.append((payload, finish, m, b._block))
    payloads = [p for p, _, _, _ in begun]
    packed = K.blockscale_compress_grouped(
        payloads, [block for _, _, _, block in begun])
    _decompress_all({k: (c, s, p) for k, ((c, s), p)
                     in enumerate(zip(packed, payloads))})
    out = []
    for _, finish, m, _ in begun:
        st, q, m2 = finish()
        out.append((st, q, {**m, **m2}))
    return out


def _slots(ids: torch.Tensor) -> torch.Tensor:
    """(B, L) ids on the device -> their occurrence slots: ``b * L + l``
    where the id is valid (>= 0), -1 at padding (int32, on the device)."""
    B, L = ids.shape
    slot = torch.arange(B * L, dtype=torch.int32,
                        device=ids.device).view(B, L)
    return torch.where(ids >= 0, slot, -1)


def _host_slots(ids: np.ndarray) -> np.ndarray:
    """:func:`_slots` of host (B, L) ids, on the host (int32)."""
    return np.where(ids >= 0, np.arange(ids.size, dtype=np.int32)
                    .reshape(ids.shape), -1).astype(np.int32)


def _pool_rows(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, L, dim) occurrence rows and their (B, L) ids on the device ->
    (B, dim) sum over the valid (id >= 0) slots, through ``embedding_bag``
    over the rows themselves."""
    B, L = ids.shape
    return K.embedding_bag(rows.reshape(B * L, -1).contiguous(), _slots(ids))


def parse_backend_name(name: str | None) -> tuple[str, bool]:
    """``EmbeddingSpec.backend`` string -> (base, compressed?). Accepted
    forms, as in the JAX package: ``dense``, ``host_lru``, ``host_lru+disk``
    (``base`` keeps the ``+disk`` marker), plus a ``+compressed`` suffix on
    any of them (``compressed`` alone means ``dense+compressed``)."""
    name = (name or "dense").strip().lower()
    parts = name.split("+")
    base, flags = parts[0], parts[1:]
    wrap = "compressed" in flags
    if base in ("", "compressed"):
        base, wrap, flags = "dense", True, [f for f in flags
                                            if f != "compressed"]
    unknown = [f for f in flags if f not in ("compressed", "disk")]
    if unknown:
        raise ValueError(
            f"unknown backend decorator {unknown[0]!r} in {name!r} "
            "(only '+disk' and '+compressed' exist)")
    if base not in ("dense", "host_lru"):
        raise ValueError(
            f"unknown embedding backend {name!r}: expected 'dense', "
            "'host_lru' or 'host_lru+disk', optionally with a "
            "'+compressed' suffix")
    if "disk" in flags:
        if base != "host_lru":
            raise ValueError(
                f"the '+disk' tier only stacks under 'host_lru' "
                f"(got {name!r})")
        base = "host_lru+disk"
    return base, wrap


def create_backend(spec: EmbeddingSpec) -> EmbeddingBackend:
    """``spec.backend`` -> backend instance (see :func:`parse_backend_name`):
    ``dense`` or ``host_lru[+disk]``, through the :class:`ShardedBackend`
    router when ``spec.emb_shards > 1``, optionally behind the compressed
    wire, which wraps OUTSIDE the router (one wire per table)."""
    base, wrap = parse_backend_name(spec.backend)
    if int(spec.emb_shards) > 1:
        backend: EmbeddingBackend = ShardedBackend(spec)
    elif base == "dense":
        backend = DenseBackend(spec)
    else:
        backend = HostLRUBackend(spec)
    return CompressedWireBackend(backend) if wrap else backend


def unwrap(backend: EmbeddingBackend) -> EmbeddingBackend:
    """Strip wire decorators down to the storage backend (plain or
    router)."""
    while isinstance(backend, CompressedWireBackend):
        backend = backend.inner
    return backend


def ensure_shards(backend: EmbeddingBackend, k: int) -> EmbeddingBackend:
    """Route a backend through a ``k``-shard router (the
    ``PersiaTrainer.init(emb_shards=...)`` path). ``k == 1`` means no
    override and returns the backend as it is: it never undoes a spec's
    router. A dense table whose spec has no ``emb_shards`` keeps the legacy
    meaning (``init(shards=k)`` pads its rows), so only host-backed tables
    and routers of another count are rebuilt here."""
    if int(k) == 1:
        return backend
    inner = unwrap(backend)
    if isinstance(inner, ShardedBackend):
        if inner.n_shards == int(k):
            return backend
    elif not isinstance(inner, HostLRUBackend):
        return backend                      # dense: the legacy row padding
    new_inner = ShardedBackend(
        dataclasses.replace(inner.spec, emb_shards=int(k)))
    return CompressedWireBackend(new_inner) \
        if isinstance(backend, CompressedWireBackend) else new_inner


def make_backends(collection) -> dict[str, EmbeddingBackend]:
    """One backend instance per table."""
    return {n: create_backend(s) for n, s in collection.items()}


def shard_step_metrics(backends) -> dict:
    """Host-side per-shard gauges for the step-metrics dict:
    ``shard/<table>/<k>/{hit_rate,faults,rows,bytes}`` plus the
    ``shard/<table>/imbalance`` max/mean traffic gauge. Empty (and cheap)
    when no table is sharded."""
    out = {}
    for n, b in backends.items():
        for k, v in b.shard_metrics().items():
            out[f"shard/{n}/{k}"] = v
    return out


# ---------------------------------------------------------------------------
# collection-level fan-outs: prepare (host), lookup and put (device)
# ---------------------------------------------------------------------------

def _upload(arrays: list[np.ndarray], dtype, device) -> list[torch.Tensor]:
    """Host arrays -> tensors of ``dtype`` on ``device`` through ONE
    host-to-device copy (from a fresh pinned buffer, without a
    synchronisation, on a GPU)."""
    if not arrays:
        return []
    sizes = [a.size for a in arrays]
    buf = torch.from_numpy(np.concatenate(
        [np.ascontiguousarray(a, dtype).reshape(-1) for a in arrays]))
    if torch.device(device).type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    elif torch.device(device).type == "meta":          # the dry run
        buf = buf.to("meta")
    parts = torch.split(buf, sizes)
    return [p.view(a.shape) for p, a in zip(parts, arrays)]


def upload_int32(arrays: list[np.ndarray], device) -> list[torch.Tensor]:
    """Host int32 arrays -> tensors on ``device`` through ONE host-to-device
    copy (from pinned memory, without a synchronisation, on a GPU): the
    step's index arrays travel together."""
    return _upload(arrays, np.int32, device)


def _upload_read(host: dict, device) -> dict:
    """{table: (int32 arrays, fp32 rows or None)} of serve reads -> {table:
    (int32 tensors, fp32 rows tensor or None)} on ``device``: every
    table's index arrays in ONE copy and every table's rows in one
    more."""
    ints = iter(upload_int32([a for arrs, _ in host.values() for a in arrs],
                             device))
    rows = iter(_upload([r for _, r in host.values() if r is not None],
                        np.float32, device))
    return {n: ([next(ints) for _ in arrs], None if r is None else next(rows))
            for n, (arrs, r) in host.items()}


def _bags(ids) -> np.ndarray:
    """Serve-read ids as host (B, L) bags."""
    arr = _host_ids(ids)
    if arr.ndim != 2:
        raise ValueError(f"read_pooled takes (B, L) bags, got shape "
                         f"{arr.shape}")
    return arr


def prepare_all(backends, states, ids, device, lock=None, pins=None):
    """Host-level per-table prepare: batch dedup + fault-in (host_lru) + id
    translation, once per (table, batch), then one upload of every index
    array to ``device``.

    For tables with ``spec.batch_dedup`` (the default) this builds the
    :class:`~repro_torch.core.dedup.DedupPlan` on the host — unique ids,
    inverse, physical rows and the occurrence CSR — and returns it as the
    table's dev-ids entry; legacy tables (``batch_dedup=False``) keep their
    occurrence-width ids.

    It runs in three phases: every table's plan (numpy, touching no
    state), then every table's ``prepare`` (a host_lru table's slot map,
    eviction and fault-in, which touch its state in place; a router's
    shards on its pool), then the translation to table rows (a router
    table's :class:`~repro_torch.core.dedup.ShardParts`), the occurrence
    CSRs and the upload. The middle phase submits every table's prepare
    before it collects any (``prepare_submit``): a remote table buffers
    its fault-in into one coalesced frame per PS endpoint, so a step pays
    one round trip per endpoint, not one per table. A remote table's plan
    carries no table rows (they live in the PS); its device ids join the
    one upload. Only
    the middle phase runs under ``lock`` when one is given (the pipelined
    trainer's store lock). With a dict ``pins``, each table's host device
    ids are pinned in its backend inside that phase, right after its
    prepare, and stored in ``pins`` for the unpin.

    Returns ``(new_states, dev_ids, metrics)`` where metrics carries the
    per-table ``dedup/<table>/{dup_factor,unique_rows,bytes_saved}``
    host gauges and, for tables with cache admission, the
    ``cache/<table>/{admit,bypass,promote}`` ones."""
    check_mesh(backends)
    new_states = dict(states)
    plans, metrics, n_unique = {}, {}, {}
    mesh = _on_mesh()
    # under a mesh a table with host-side state (host_lru, a router over
    # host_lru shards, a remote host_lru table) prepares the global batch's
    # ids on every rank (one all_gather for all of them), as one process
    # prepares them, and each rank's plan then reads its own ids' slots
    glob = _gather_batch_ids({n: _host_ids(ids[n]) for n in ids
                              if mesh and _host_state(backends[n])})
    prep = {}                  # what each table's prepare takes
    for n in ids:
        b = backends[n]
        arr = _host_ids(ids[n])
        if not b.spec.batch_dedup:
            plans[n] = (arr,)
            prep[n] = (glob.get(n, arr), False, None)
            continue
        cap = D.dedup_cap(max(arr.size, 1), b.dedup_rows())
        u, inv, counts, info = D.make_plan(arr, b.spec.rows, cap)
        if mesh:                # one plan width on every rank
            u, counts = _pad_to(u, cap), _pad_to(counts, cap, 0)
        plans[n] = (u, inv, counts, info)
        prep[n] = (u, True, counts)
        if n in glob:           # the global batch's plan, one process's
            g = glob[n]
            gu, _, gc, _ = D.make_plan(g, b.spec.rows, D.dedup_cap(
                max(g.size, 1), b.dedup_rows()))
            prep[n] = (gu, True, gc)
    # a remote table's host-side prepare runs on the mesh's first rank
    # alone (it holds the PS connections); the others take its result
    lead = not mesh or get_mesh().rank == 0
    shared = [n for n in plans if mesh and unwrap(backends[n]).remote
              and n in glob]
    devs = {}
    with lock if lock is not None else contextlib.nullcontext():
        submitted = {n: backends[n].prepare_submit(states[n], *prep[n])
                     for n in plans if lead or n not in shared}
        for n, collect in submitted.items():
            new_states[n], dev = collect()
            devs[n] = np.asarray(dev, np.int32)
        if shared:
            got = from_rank0({n: (devs[n], unwrap(backends[n]).counters())
                              for n in shared} if lead else None)
            for n in shared:
                devs[n] = got[n][0]
                unwrap(backends[n]).set_counters(got[n][1])
        for n in plans:
            b = backends[n]
            pinned = devs[n]
            if n in glob:       # this rank's own ids' device ids
                devs[n] = _map_ids(plans[n][0], prep[n][0], pinned)
            _cache_tags(metrics, n, b)
            if pins is not None:
                b.pin_slots(pinned)
                pins[n] = pinned
    host = {}
    for n, plan in plans.items():
        dev_u = devs[n]
        if len(plan) == 1:
            host[n] = ("flat", [dev_u])
            continue
        b, spec = backends[n], backends[n].spec
        u, inv, _, info = plan
        order, offsets = D.occurrence_csr(inv, dev_u.shape[0])
        inner = unwrap(b)
        if inner.remote:
            host[n] = ("remote", [dev_u, inv, order, offsets])
        elif isinstance(inner, ShardedBackend) and mesh:
            # under a mesh a router reads its shards through the mesh
            # lookup and queues its shards' puts by their logical ids
            host[n] = ("ids", [dev_u, inv, order, offsets, u])
        elif isinstance(inner, ShardedBackend):
            host[n] = ("router", [dev_u, inv, order, offsets,
                                  *inner.plan_parts(dev_u)])
        else:
            rows = inner.table_rows(torch.from_numpy(dev_u)).numpy()
            host[n] = ("rows", [dev_u, inv, order, offsets, rows])
            if n in glob:
                host[n] = ("rows_ids", host[n][1] + [u])
        n_unique[n] = info["n_unique"]
        itemsize = torch.empty((), dtype=spec.dtype).element_size()
        metrics[f"dedup/{n}/dup_factor"] = info["dup_factor"]
        metrics[f"dedup/{n}/unique_rows"] = float(info["n_unique"])
        metrics[f"dedup/{n}/bytes_saved"] = float(
            (info["n_occ"] - info["n_unique"]) * spec.dim * itemsize)
    flat = iter(upload_int32([a for _, arrs in host.values() for a in arrs],
                             device))
    dev_ids = {}
    for n, (kind, arrs) in host.items():
        got = [next(flat) for _ in arrs]
        if kind == "flat":
            dev_ids[n] = got[0]
            continue
        parts = None
        if kind == "router":
            k = (len(got) - 5) // 2
            parts = D.ShardParts(perm=got[4], rows=tuple(got[5:5 + k]),
                                 local=tuple(got[5 + k:]))
        dev_ids[n] = D.DedupPlan(
            dev=got[0], inv=got[1],
            rows=got[4] if kind in ("rows", "rows_ids") else None,
            order=got[2], offsets=got[3], n_unique=n_unique[n],
            host=arrs[0], shards=parts,
            ids=got[-1] if kind in ("ids", "rows_ids") else None)
    return new_states, dev_ids, metrics


def _map_ids(own: np.ndarray, keys, vals) -> np.ndarray:
    """This rank's ids -> their device ids, from the global prepare's
    ``keys`` (ids, any shape) and ``vals`` (their device ids, the same
    shape): int32 in ``own``'s shape, -1 where an id is padding or was
    given none."""
    k = np.asarray(keys, np.int64).reshape(-1)
    v = np.asarray(vals, np.int64).reshape(-1)
    ok = k >= 0
    k, first = np.unique(k[ok], return_index=True)
    v = v[ok][first]
    o = np.asarray(own, np.int64).reshape(-1)
    if k.size == 0:
        return np.full(own.shape, -1, np.int32)
    pos = np.searchsorted(k, o).clip(max=k.size - 1)
    hit = (o >= 0) & (k[pos] == o)
    return np.where(hit, v[pos], -1).astype(np.int32).reshape(own.shape)


def _gather_batch_ids(arrays: dict) -> dict:
    """{table: this rank's host ids (batch rows first)} -> {table: the
    global batch's ids}, the rows in the batch ranks' order, every table's
    ids in ONE ``all_gather`` over the batch axes. The ids travel on the
    mesh's device: NCCL carries CUDA tensors only."""
    axes = batch_axes()
    nb = axis_size(axes)
    if not arrays or nb == 1:
        return dict(arrays)
    names = list(arrays)
    x = torch.from_numpy(np.concatenate(
        [arrays[n].reshape(-1) for n in names])).to(get_mesh().device)
    got = all_gather(x, axes).cpu().numpy().reshape(nb, -1)
    out, off = {}, 0
    for n in names:
        a = arrays[n]
        out[n] = got[:, off:off + a.size].reshape((nb * a.shape[0],)
                                                  + a.shape[1:])
        off += a.size
    return out


def _host_state(backend) -> bool:
    """A table with host-side state that a prepare moves: host_lru (behind
    the wire or not), a router over host_lru shards, a remote host_lru
    table. Under a mesh it prepares the global batch's ids."""
    inner = unwrap(backend)
    return isinstance(inner, HostLRUBackend) or getattr(inner, "_host",
                                                        False)


def check_mesh(backends):
    """Under a mesh of more than one rank every tier is ported. Raise for a
    wire whose block does not divide the dim (its codec's blocks would run
    across the rows that the ranks roundtrip apart), behind the
    in-process wire or a remote table's lossy one."""
    if not _on_mesh():
        return
    for n, b in backends.items():
        inner = unwrap(b)
        wire = isinstance(b, CompressedWireBackend) or (
            inner.remote and getattr(inner, "lossy", False))
        block = int(b.spec.wire_block)
        if wire and b.spec.dim % block:
            raise NotImplementedError(
                f"table {n!r}: the compressed wire under a mesh needs "
                f"wire_block ({block}) to divide dim ({b.spec.dim}): "
                "each rank roundtrips its own rows, which equals the "
                "reference's codec over the global rows only when every "
                "row is whole blocks")


def _cache_tags(metrics, name, backend):
    for k, v in backend.cache_metrics().items():
        metrics[f"cache/{name}/{k}"] = v


def _tag(metrics, name, table_metrics):
    for k, v in table_metrics.items():
        metrics[f"wire/{name}/{k}"] = v


def lookup_all(backends, states, dev_ids):
    """Pooled lookups of every table -> ({table: (B, dim) pooled},
    metrics), ONE launch per kernel for the stage: the tables behind the
    wire gather their rows, compress in ONE launch and decompress in ONE;
    then every table pools in ONE bag launch, through a plan (``unique_bag``
    on a table's rows, or on a wire table's roundtripped unique rows with
    the identity for dev) or at occurrence width (``embedding_bag`` on a
    table's rows, or on a wire table's roundtripped occurrence rows
    through their slots). A table's rows are its backend's
    ``table_rows``: shuffled rows, or host_lru cache slots; a router
    table's unique rows are gathered into one block first
    (``ShardedBackend._bag_entry``)."""
    metrics = {}
    bags = {}                  # name -> (table, dev or None, inv, flat)
    wire = {}                  # name -> (rows, block)
    for n in dev_ids:
        if n not in backends:
            raise KeyError(f"ids for unknown table {n!r}; collection has "
                           f"{sorted(backends)}")
    # the remote tables' reads go out first (one coalesced frame per PS
    # endpoint) and travel while the in-process tables' gathers enqueue
    remote = {n: ids for n, ids in dev_ids.items() if backends[n].remote}
    if _on_mesh():
        collect = _remote_lookup_mesh(backends, states, remote)
    else:
        thunks = {n: backends[n].lookup_submit(states[n], ids)
                  for n, ids in remote.items()}
        collect = lambda m: _remote_rows(thunks, dev_ids, m)  # noqa: E731
    for n, ids in dev_ids.items():
        if n in remote:
            continue
        b, m = backends[n], {}
        if isinstance(b, CompressedWireBackend):
            rows, m = b._get_rows(states[n], ids)
            wire[n] = (rows, b._block)
        else:
            bags[n] = b._bag_entry(states[n], ids)
        _tag(metrics, n, m)
    rows = _roundtrip_all(wire)
    rows.update(collect(metrics))
    for n, r in rows.items():
        ids = dev_ids[n]
        if D.is_plan(ids):
            bags[n] = (r, None, ids.inv, False)
        else:
            bags[n] = (r.reshape(-1, r.shape[-1]), None, _slots(ids), True)
    pooled = _bag_all(bags)
    return {n: pooled[n] for n in dev_ids}, metrics


def _ids_device(ids) -> torch.device:
    return (ids.inv if D.is_plan(ids) else ids).device


def _remote_rows(remote: dict, dev_ids, metrics) -> dict:
    """{table: collect thunk} of remote lookups -> {table: rows on the
    ids' device}: the rows that came back over the wire (a plan's unique
    rows, else the occurrence rows), ALL uploaded in one copy."""
    if not remote:
        return {}
    got = {n: t() for n, t in remote.items()}
    for n, (_, m) in got.items():
        _tag(metrics, n, m)
    up = _upload([r for r, _ in got.values()], np.float32,
                 _ids_device(dev_ids[next(iter(got))]))
    return dict(zip(got, up))


def _remote_lookup_mesh(backends, states, dev_ids: dict):
    """Under a mesh, the remote tables' lookups of the global batch as one
    process sends them: every rank's device ids gathered over the batch
    axes (a plan's unique ids, or the occurrences), the mesh's first rank
    alone reading the global batch's unique rows (or its occurrences'
    rows) from the PS, one read a table. Returns ``collect(metrics)`` ->
    {table: this rank's rows on its ids' device}: the first rank sends
    every table's rows to the others in one broadcast, and each rank
    takes its own (bit for bit the PS's rows)."""
    if not dev_ids:
        return lambda m: {}
    axes = batch_axes()
    lead = get_mesh().rank == 0
    want, futs = {}, {}
    for n, ids in dev_ids.items():
        plan = D.is_plan(ids)
        own = (ids.dev if plan else ids).reshape(-1).to(torch.int32)
        got = all_gather(own.contiguous(), axes).cpu().numpy()
        if plan:
            keys = np.unique(got[got >= 0]).astype(np.int32)
            want[n] = (keys, _host_ids(ids.host if ids.host is not None
                                       else ids.dev))
            req = D.DedupPlan(dev=None, inv=None, host=keys)
        else:
            w = int(own.numel())
            want[n] = (None, slice(flat_index(axes) * w,
                                   (flat_index(axes) + 1) * w))
            req = torch.from_numpy(got)
        if lead:
            futs[n] = backends[n].lookup_submit(states[n], req)

    def collect(metrics):
        got = from_rank0({n: f() for n, f in futs.items()} if lead
                         else None)
        rows = []
        for n, (keys, own) in want.items():
            r, m = got[n]
            _tag(metrics, n, m)
            if keys is None:
                rows.append(r[own])
                continue
            out = np.zeros((own.size, r.shape[1]), np.float32)
            if keys.size:
                pos = np.searchsorted(keys, own).clip(max=keys.size - 1)
                hit = (own >= 0) & (keys[pos] == own)
                out[hit] = r[pos[hit]]
            rows.append(out)
        ids0 = next(iter(dev_ids.values()))
        return dict(zip(want, _upload(rows, np.float32, _ids_device(ids0))))
    return collect


def _remote_puts_mesh(items) -> list:
    """Under a mesh, the remote tables' puts as one process sends them:
    each rank's unique-width sums (one sum-only ``fused_backward``
    launch a table) gathered over the batch axes with their device ids
    and deduplicated again on the device ids (one more sum-only launch),
    or a table at occurrence width its occurrences gathered as they are;
    the mesh's first rank alone puts the global put to the PS (one put a
    table and step, at the queue width of the global batch). Every rank's
    queue placeholder turns as the PS queue does. Returns [(state, queue,
    metrics)]: the put's byte metrics on the first rank."""
    axes = batch_axes()
    nb = axis_size(axes)
    lead = get_mesh().rank == 0
    begun = []
    for b, state, queue, ids, g in items:
        if D.is_plan(ids):
            key = ids.dev.to(torch.int32).contiguous()
            g = _plan_sums(ids, g)
        else:
            key = ids.reshape(-1).to(torch.int32).contiguous()
            g = g.reshape(-1, b.spec.dim).float()
        key_all = all_gather(key, axes)
        g_all = all_gather(g.contiguous(), axes)
        if not lead:
            begun.append(None)
        elif D.is_plan(ids):
            width = int(key_all.shape[0])
            glob = C.dedup_plan(key_all, width)
            begun.append((glob.dev, D.csr_segment_sum(
                glob.order, glob.offsets, g_all, width), True))
        else:
            begun.append(b.put_sums(key_all, g_all))
    host = iter(_download([x for one in begun if one is not None
                           for x in one[:2]]))
    out = []
    for (b, state, queue, _, _), one in zip(items, begun):
        m = {}
        if one is not None:
            _, _, m = b.put_host(state, _wide_queue(queue, nb), next(host),
                                 next(host), one[2])
        out.append((state, b.pushed(queue), m))
    return out


def _wide_queue(q, n: int):
    """A queue placeholder ``n`` times as wide: the PS queue of the global
    batch, whose width a put op names."""
    if q is None:
        return None
    if "ids" not in q:
        return {k: _wide_queue(v, n) for k, v in q.items()}
    tau, w = int(q["ids"].shape[0]), int(q["ids"].shape[1])
    return dict(q, ids=q["ids"][:, :1].expand(tau, w * n))


def _download(tensors) -> list[np.ndarray]:
    """Tensors -> host numpy arrays: each device tensor copied into fresh
    pinned memory without a wait, then ONE wait for the stream; host
    tensors and numpy arrays as they are."""
    out, wait = [], None
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t.detach(), non_blocking=True)
            out.append(buf)
            wait = t.device
        else:
            out.append(t)
    if wait is not None:
        torch.cuda.current_stream(wait).synchronize()
    return [t.detach().numpy() if isinstance(t, torch.Tensor) else t
            for t in out]


def _remote_puts(items) -> list:
    """The puts of remote tables, ``items`` of (backend, state, queue,
    dev_ids, grads), in three phases: (1) every table's unique-width sums
    (one sum-only ``fused_backward`` launch a table; a table at
    occurrence width sends its gradients as they are); (2) every table's
    sums copied to the host, ONE wait for the stream; (3) every table's
    put buffered on its PS connection (coalesced into one frame per
    endpoint, acked in a window), where the PS applies it. Returns
    [(state, queue, metrics)]."""
    begun = [b.put_sums(ids, g) for b, _, _, ids, g in items]
    host = iter(_download([x for ids, g, _ in begun for x in (ids, g)]))
    return [b.put_host(state, queue, next(host), next(host), unique)
            for (b, state, queue, _, _), (_, _, unique) in zip(items, begun)]


def lookup_occurrences_all(backends, states, dev_ids):
    """Occurrence activations of every table -> ({table: (*ids.shape,
    dim)}, metrics), for a loss that takes them unpooled (the LM): each
    table's :meth:`EmbeddingBackend.lookup`, the gather of its unique rows
    (behind the wire: roundtripped) scattered through the plan's ``inv``.
    The gradient of these activations goes to :func:`put_all` as it is."""
    metrics, acts = {}, {}
    for n, ids in dev_ids.items():
        if n not in backends:
            raise KeyError(f"ids for unknown table {n!r}; collection has "
                           f"{sorted(backends)}")
        acts[n], m = backends[n].lookup(states[n], ids)
        _tag(metrics, n, m)
    return acts, metrics


def _columns(items: dict, width: int) -> list[list]:
    return [[a[k] for a in items.values()] for k in range(width)]


def _bag_all(bags: dict) -> dict:
    """{table: (table, dev or None, inv, flat)} -> {table: (B, dim)
    pooled}, in ONE bag launch (``flat``: an occurrence-width table)."""
    tables, devs, invs, flat = _columns(bags, 4)
    return dict(zip(bags, K.unique_bag_grouped(tables, devs, invs, flat)))


def _decompress_all(items: dict) -> dict:
    """{table: (comp, scales, out or shape)} -> {table: decompressed}, in
    one ``blockscale_decompress`` launch."""
    return dict(zip(items,
                    K.blockscale_decompress_grouped(*_columns(items, 3))))


def _roundtrip_all(items: dict) -> dict:
    """{table: (contiguous fp32 rows, block)} -> {table: the rows after
    crossing the wire}, in ONE compress and ONE decompress launch."""
    rows, blocks = _columns(items, 2)
    packed = K.blockscale_compress_grouped(rows, blocks)
    return _decompress_all({n: (c, s, r.shape) for n, (c, s), r
                            in zip(items, packed, rows)})


def put_all(backends, states, queues, dev_ids, grads):
    """Hybrid updates of every table (push this step's put, apply the
    tau-stale one) -> (states, queues, metrics). Dense tables put through
    one ``fused_backward`` launch each; the tables behind the wire run
    their puts in phases that share ONE compress and ONE decompress
    (:func:`_wire_puts`); the remote tables sum here and apply in their
    PS processes (:func:`_remote_puts`)."""
    queues = queues or {}
    new_states, new_queues, metrics = dict(states), dict(queues), {}
    wire = [n for n in dev_ids if isinstance(backends[n],
                                             CompressedWireBackend)]
    remote = [n for n in dev_ids if backends[n].remote]
    puts = _remote_puts_mesh if _on_mesh() else _remote_puts
    done = dict(zip(remote, puts(
        [(backends[n], states[n], queues.get(n), dev_ids[n], grads[n])
         for n in remote])))
    done.update({n: backends[n].hybrid_update(states[n], queues.get(n),
                                              dev_ids[n], grads[n])
                 for n in dev_ids if n not in wire and n not in remote})
    done.update(zip(wire, _wire_puts(
        [(backends[n], states[n], queues.get(n), dev_ids[n], grads[n])
         for n in wire])))
    for n in dev_ids:
        new_states[n], new_queues[n], m = done[n]
        _tag(metrics, n, m)
    return new_states, new_queues, metrics


_INT32_MAX = int(np.iinfo(np.int32).max)


def read_pooled_all(backends, states, ids, device):
    """Serve-path pooled reads of every table (the per-table
    :meth:`EmbeddingBackend.read_pooled`, grouped): LOGICAL (B, L) ids per
    table -> ({table: (B, dim) fp32 pooled}, {table: read gauges}). Every
    table's index arrays (a dense table's plan or occurrence rows, a
    host_lru table's inverse and hit slots, a wire table's occurrence
    slots beside its inner table's) are built on the host and uploaded in
    ONE copy, a host_lru table's misses, read from its host store, in one
    more; the tables behind the wire gather their occurrence rows,
    compress in ONE launch and decompress in ONE; then every table pools
    in ONE bag launch (``unique_bag`` through a plan or over a host_lru
    read's unique rows, ``embedding_bag`` at occurrence width and behind
    the wire). A remote table's read is one RPC, coalesced with the
    others' into one frame per PS endpoint; its rows ride in the rows'
    copy. Read-only: the host_lru tables' locks are held from the
    residency resolution until their gathers are enqueued."""
    check_mesh(backends)
    # the remote tables' reads go out first, one coalesced frame per PS
    # endpoint; the PS resolves each under its own lock
    remote = {n: backends[n].read_submit(_bags(x)) for n, x in ids.items()
              if backends[n].remote}
    # (under a mesh a remote table's read_submit is a collective: every
    # rank submits, in table order, and the first rank reads for all)
    with contextlib.ExitStack() as held:
        for n in ids:
            held.enter_context(backends[n].read_lock())
        host, info = {}, {}
        for n, x in ids.items():
            if n in remote:
                arrs, rows, info[n] = remote[n]()
                host[n] = (arrs, rows)
                continue
            b, arr = backends[n], _bags(x)
            wire = isinstance(b, CompressedWireBackend)
            arrs, rows, info[n] = unwrap(b)._read_begin(arr, occ=wire)
            if wire:
                arrs = arrs + [_host_slots(arr)]
            host[n] = (arrs, rows)
        got = _upload_read(host, device)
        bags, wire = {}, {}
        for n, (idx, rows) in got.items():
            b = backends[n]
            if isinstance(b, CompressedWireBackend):
                occ = b.inner._read_end(states[n], idx[:-1], rows, occ=True)
                wire[n] = (occ.float().contiguous(), b._block)
            else:
                bags[n] = b._read_end(states[n], idx, rows)
    for n, rows in _roundtrip_all(wire).items():
        bags[n] = (rows.reshape(-1, rows.shape[-1]), None, got[n][0][-1],
                   True)
    pooled = _bag_all(bags)
    return {n: pooled[n] for n in ids}, info
