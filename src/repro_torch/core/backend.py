"""Embedding storage backends (port of ``repro/core/backend.py``): the
protocol base, the device-resident ``DenseBackend`` and the §4.2.3
compressed wire (``CompressedWireBackend``), with the factory that builds
them from ``EmbeddingSpec.backend``.

The serving path reads every table through :func:`read_pooled_all` (the
per-table :meth:`EmbeddingBackend.read_pooled`, grouped), which returns
the sum-pooled bags straight from the CUDA kernels: with
``spec.batch_dedup`` (the default) the host builds a
:class:`~repro_torch.core.dedup.DedupPlan` and ``unique_bag`` gathers,
scatters and pools at unique width; without it ``embedding_bag`` pools at
occurrence width. That is the trainer's own choice between plan and flat
ids in the JAX package (``prepare_all``), applied to the read. Both are
one bag kernel (``embedding_bag`` is its identity case), so every table of
a read pools in ONE launch.

The training path: ``prepare_all`` builds every table's plan on the host
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
(the JAX trainer donates them).

``CompressedWireBackend`` wraps the dense backend: its gets and puts cross
the wire as blockscale fp16 (the ``blockscale_compress`` /
``blockscale_decompress`` CUDA kernels) and its puts are deduplicated to
one row per unique id. The stage's tables compress together and
decompress together: ONE launch of each per get, put or serve read. The
host-cached and sharded backends come with later slices; the factory
refuses them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.core import dedup as D
from repro_torch.core import embedding_ps as PS
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.kernels import ops as K


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
    is a dict of tensors threaded through by the caller.

    The device-side ops accept device ids in two forms: a raw id tensor
    (one row per occurrence) or a :class:`~repro_torch.core.dedup.
    DedupPlan` (``dev`` unique device ids + ``inv`` occurrence -> unique
    inverse), which gathers the unique rows and scatters them through the
    inverse, and whose puts segment-sum the occurrence gradients to unique
    width once, here."""

    spec: EmbeddingSpec

    # -- host-level ----------------------------------------------------------
    def init(self, generator: torch.Generator, shards: int = 1,
             scale: float = 0.02):
        raise NotImplementedError

    def prepare(self, state, ids, assume_unique: bool = False, counts=None):
        """(state, ids) -> (state, device_ids). Host-level, once per step.
        ``assume_unique`` marks ids as an already-deduped set (a plan's
        unique ids); ``counts`` carries the per-unique occurrence counts."""
        return state, ids

    def read_rows(self, state, ids):
        """Serve-path read at occurrence width: LOGICAL ids -> ``(rows,
        info)`` with ``rows`` fp32 of shape ``ids.shape + (dim,)`` on the
        table's device, and ``info`` the read gauges ``reads`` (unique ids
        resolved), ``hits`` (served from device-resident rows) and
        ``misses`` (served from a host tier). Read-only. Invalid ids (< 0 or
        >= rows) read as zero rows.

        This is the plain gather (no kernel); the device-resident default
        goes through the backend's own lookup, so every read is a hit."""
        arr = _host_ids(ids)
        acts, _ = self._lookup_flat(
            state, torch.as_tensor(arr, device=state["table"].device))
        n = _n_distinct(arr.reshape(-1), self.spec.rows)
        return acts.float(), {"reads": n, "hits": n, "misses": 0}

    def read_pooled(self, state, ids):
        """Serve-path read, pooled: LOGICAL ids (B, L) -> ``(pooled,
        info)`` with ``pooled`` the (B, dim) fp32 sum over each bag's valid
        rows and ``info`` the same gauges as :meth:`read_rows`. Read-only."""
        raise NotImplementedError

    def dedup_rows(self) -> int:
        """Upper bound on distinct device ids one batch can produce — the
        denominator of the dedup capacity rule for this backend."""
        return self.spec.rows

    def queue_width(self, n_occ: int) -> int:
        """Width of this table's staleness-queue slots for a batch of
        ``n_occ`` id occurrences: the dedup cap under batch dedup, the raw
        occurrence count on the legacy path."""
        if self.spec.batch_dedup:
            return D.dedup_cap(n_occ, self.dedup_rows())
        return int(n_occ)

    def queue_init(self, ids_shape, device=None):
        raise NotImplementedError

    def state_for_checkpoint(self, state):
        raise NotImplementedError

    def restore_from_checkpoint(self, blob):
        """Validate a checkpoint blob (host numpy arrays) and return the
        table state to restore; the trainer moves it to its device."""
        raise NotImplementedError

    # -- device-side ---------------------------------------------------------

    def lookup(self, state, dev_ids):
        """Occurrence activations (*ids.shape, dim), read by the plain
        gather."""
        if D.is_plan(dev_ids):
            acts_u, m = self._lookup_unique(state, dev_ids.dev)
            return D.plan_scatter(acts_u, dev_ids.inv), m
        return self._lookup_flat(state, dev_ids)

    def lookup_pooled(self, state, dev_ids):
        """Pooled bags (B, dim) through the bag kernels: a plan reads
        through ``unique_bag``, flat (B, L) logical ids (translated to rows
        where they lie, then copied to the table's device) through
        ``embedding_bag``. Returns ``(pooled, metrics)``."""
        raise NotImplementedError

    def apply_put(self, state, dev_ids, grads):
        if D.is_plan(dev_ids):
            return self._put_plan(state, dev_ids, grads)
        return self._put_flat(state, dev_ids, grads)

    def hybrid_update(self, state, queue, dev_ids, grads):
        if D.is_plan(dev_ids):
            return self._hybrid_plan(state, queue, dev_ids, grads)
        return self._hybrid_flat(state, queue, dev_ids, grads)

    def _put_plan(self, state, plan, grads):
        """Plan-driven put. Default: the plan's segment-sum, then the
        unique-width put. DenseBackend overrides it with the fused kernel."""
        g_u = D.plan_segment_sum(plan.inv, grads, int(plan.dev.shape[0]))
        return self._put_unique(state, plan.dev, g_u)

    def _hybrid_plan(self, state, queue, plan, grads):
        g_u = D.plan_segment_sum(plan.inv, grads, int(plan.dev.shape[0]))
        return self._hybrid_unique(state, queue, plan.dev, g_u)

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


class DenseBackend(EmbeddingBackend):
    """Device-resident PS shard; device ids ARE the logical ids."""

    def __init__(self, spec: EmbeddingSpec):
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

    def _logical_to_pos(self, ids: torch.Tensor) -> torch.Tensor:
        """Logical id -> physical shuffled row as int32; padding and ids
        out of range (< 0 or >= rows) become -1."""
        spec = self.spec
        valid = (ids >= 0) & (ids < spec.rows)
        pos = PS.shuffle_pos(torch.where(valid, ids, 0), spec.padded_rows(1))
        return torch.where(valid, pos, -1).to(torch.int32)

    def _plan_rows(self, plan) -> torch.Tensor:
        return plan.rows if plan.rows is not None \
            else self._logical_to_pos(plan.dev)

    def lookup_pooled(self, state, dev_ids):
        table = state["table"]
        if D.is_plan(dev_ids):
            return K.unique_bag(table, self._plan_rows(dev_ids),
                                dev_ids.inv), {}
        return K.embedding_bag(
            table, self._logical_to_pos(dev_ids).to(table.device)), {}

    def _read_host(self, ids):
        """The host side of a pooled serve read: LOGICAL (B, L) ids ->
        (the int32 index arrays to upload, distinct ids read). With
        ``spec.batch_dedup`` the plan's inverse and physical rows (for
        ``unique_bag``), else the occurrence rows (for ``embedding_bag``);
        the translation to physical rows runs on the host, beside the
        plan."""
        arr = _host_ids(ids)
        if arr.ndim != 2:
            raise ValueError(f"read_pooled takes (B, L) bags, got shape "
                             f"{arr.shape}")
        spec = self.spec
        if spec.batch_dedup:
            cap = D.dedup_cap(max(arr.size, 1), self.dedup_rows())
            u_pad, inv, _, info = D.make_plan(arr, spec.rows, cap)
            rows = self._logical_to_pos(torch.from_numpy(u_pad)).numpy()
            return [inv, rows], info["n_unique"]
        rows = self._logical_to_pos(torch.from_numpy(arr)).numpy()
        return [rows], _n_distinct(arr.reshape(-1), spec.rows)

    def read_pooled(self, state, ids):
        arrs, n = self._read_host(ids)
        table = state["table"]
        idx = upload_int32(arrs, table.device)
        pooled = K.unique_bag(table, idx[1], idx[0]) if len(idx) == 2 \
            else K.embedding_bag(table, idx[0])
        return pooled, {"reads": n, "hits": n, "misses": 0}

    def _put_unique(self, state, dev_u, g_u):
        return PS.apply_put(state, self.spec, dev_u, g_u,
                            assume_unique=True), {}

    def _put_flat(self, state, dev_ids, grads):
        return PS.apply_put(state, self.spec, dev_ids.reshape(-1),
                            grads.reshape(-1, self.spec.dim)), {}

    def _put_plan(self, state, plan, grads):
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

    def _wire_begin(self, state, queue, plan, grads):
        """A put whose unique-width sums cross the wire between their sum
        and the PS, up to the wire: ``(payload, finish)`` as
        :meth:`_hybrid_begin`; the caller roundtrips ``payload`` IN PLACE
        before it calls ``finish()``. In sync mode the sums are a sum-only
        launch here and their apply an apply-only launch in ``finish``."""
        if self.spec.staleness > 0 and queue is not None:
            return self._hybrid_begin(state, queue, plan, grads)
        g_u = D.csr_segment_sum(*_plan_csr(plan), grads,
                                int(plan.dev.shape[0]))

        def finish():
            st, m = self._put_unique(state, plan.dev, g_u)
            return st, queue, m
        return g_u, finish

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

    def state_for_checkpoint(self, state):
        return {k: v.detach().cpu().numpy() for k, v in state.items()}

    def restore_from_checkpoint(self, blob):
        spec = self.spec
        if isinstance(blob, dict) and "shard_meta" in blob:
            raise NotImplementedError(
                "this checkpoint holds a sharded-router table: resharding "
                "on restore is not ported yet")
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


class CompressedWireBackend(EmbeddingBackend):
    """The paper's §4.2.3 communication compression, as a decorator over
    the dense backend: gradient puts are deduplicated to one row per unique
    id (lossless), and both get and put payloads cross the wire as
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

    def queue_width(self, n_occ: int) -> int:
        # the wire ALWAYS dedups its puts (even at occurrence width), so its
        # queue is capped whatever batch_dedup says
        return D.dedup_cap(n_occ, self.dedup_rows())

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
            rows, m = self.inner._lookup_unique(state, dev_ids.dev)
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
            plan = C.dedup_plan(flat, D.dedup_cap(n_put, self.dedup_rows()))
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
    any of them (``compressed`` alone means ``dense+compressed``). The port
    builds ``dense`` and ``dense+compressed`` (:func:`create_backend`)."""
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
    ``dense``, or ``dense`` behind the compressed wire."""
    base, wrap = parse_backend_name(spec.backend)
    if base != "dense":
        raise ValueError(f"embedding backend {spec.backend!r} is not ported "
                         "yet: the torch port builds 'dense' and "
                         "'dense+compressed'")
    backend = DenseBackend(spec)
    return CompressedWireBackend(backend) if wrap else backend


def unwrap(backend: EmbeddingBackend) -> EmbeddingBackend:
    """Strip wire decorators down to the storage backend."""
    while isinstance(backend, CompressedWireBackend):
        backend = backend.inner
    return backend


def make_backends(collection) -> dict[str, EmbeddingBackend]:
    """One backend instance per table."""
    return {n: create_backend(s) for n, s in collection.items()}


# ---------------------------------------------------------------------------
# collection-level fan-outs: prepare (host), lookup and put (device)
# ---------------------------------------------------------------------------

def upload_int32(arrays: list[np.ndarray], device) -> list[torch.Tensor]:
    """Host int32 arrays -> tensors on ``device`` through ONE host-to-device
    copy (from pinned memory, without a synchronisation, on a GPU): the
    step's index arrays travel together."""
    if not arrays:
        return []
    sizes = [a.size for a in arrays]
    buf = torch.from_numpy(np.concatenate(
        [np.ascontiguousarray(a, np.int32).reshape(-1) for a in arrays]))
    if torch.device(device).type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    parts = torch.split(buf, sizes)
    return [p.view(a.shape) for p, a in zip(parts, arrays)]


def prepare_all(backends, states, ids, device):
    """Host-level per-table prepare: batch dedup + id translation, once per
    (table, batch), then one upload of every index array to ``device``.

    For tables with ``spec.batch_dedup`` (the default) this builds the
    :class:`~repro_torch.core.dedup.DedupPlan` on the host — unique ids,
    inverse, physical rows and the occurrence CSR — and returns it as the
    table's dev-ids entry; legacy tables (``batch_dedup=False``) keep their
    occurrence-width ids.

    Returns ``(new_states, dev_ids, metrics)`` where metrics carries the
    per-table ``dedup/<table>/{dup_factor,unique_rows,bytes_saved}``
    host gauges."""
    new_states = dict(states)
    host, metrics, n_unique = {}, {}, {}
    for n in ids:
        b = backends[n]
        spec = b.spec
        arr = _host_ids(ids[n])
        if not spec.batch_dedup:
            new_states[n], dev = b.prepare(states[n], arr)
            host[n] = [np.asarray(dev, np.int32)]
            continue
        cap = D.dedup_cap(max(arr.size, 1), b.dedup_rows())
        u_pad, inv, counts, info = D.make_plan(arr, spec.rows, cap)
        new_states[n], dev_u = b.prepare(states[n], u_pad, assume_unique=True,
                                         counts=counts)
        dev_u = np.asarray(dev_u, np.int32)
        rows = unwrap(b)._logical_to_pos(torch.from_numpy(dev_u)).numpy()
        order, offsets = D.occurrence_csr(inv, dev_u.shape[0])
        host[n] = [dev_u, inv, rows, order, offsets]
        n_unique[n] = info["n_unique"]
        itemsize = torch.empty((), dtype=spec.dtype).element_size()
        metrics[f"dedup/{n}/dup_factor"] = info["dup_factor"]
        metrics[f"dedup/{n}/unique_rows"] = float(info["n_unique"])
        metrics[f"dedup/{n}/bytes_saved"] = float(
            (info["n_occ"] - info["n_unique"]) * spec.dim * itemsize)
    flat = iter(upload_int32([a for arrs in host.values() for a in arrs],
                             device))
    dev_ids = {}
    for n, arrs in host.items():
        got = [next(flat) for _ in arrs]
        dev_ids[n] = got[0] if len(got) == 1 else D.DedupPlan(
            dev=got[0], inv=got[1], rows=got[2], order=got[3],
            offsets=got[4], n_unique=n_unique[n])
    return new_states, dev_ids, metrics


def _tag(metrics, name, table_metrics):
    for k, v in table_metrics.items():
        metrics[f"wire/{name}/{k}"] = v


def lookup_all(backends, states, dev_ids):
    """Pooled lookups of every table -> ({table: (B, dim) pooled},
    metrics), ONE launch per kernel for the stage: the tables behind the
    wire gather their rows, compress in ONE launch and decompress in ONE;
    then every table pools in ONE bag launch, through a plan (``unique_bag``
    on a dense table's physical rows, or on a wire table's roundtripped
    unique rows with the identity for dev) or at occurrence width
    (``embedding_bag`` on a dense table's physical rows, or on a wire
    table's roundtripped occurrence rows through their slots)."""
    metrics = {}
    bags = {}                  # name -> (table, dev or None, inv, flat)
    wire = {}                  # name -> (rows, block)
    for n, ids in dev_ids.items():
        if n not in backends:
            raise KeyError(f"ids for unknown table {n!r}; collection has "
                           f"{sorted(backends)}")
        b, m, table = backends[n], {}, states[n]["table"]
        if isinstance(b, CompressedWireBackend):
            rows, m = b._get_rows(states[n], ids)
            wire[n] = (rows, b._block)
        elif D.is_plan(ids):
            bags[n] = (table, b._plan_rows(ids), ids.inv, False)
        else:
            bags[n] = (table, None,
                       b._logical_to_pos(ids).to(table.device), True)
        _tag(metrics, n, m)
    for n, rows in _roundtrip_all(wire).items():
        ids = dev_ids[n]
        if D.is_plan(ids):
            bags[n] = (rows, None, ids.inv, False)
        else:
            bags[n] = (rows.reshape(-1, rows.shape[-1]), None, _slots(ids),
                       True)
    pooled = _bag_all(bags)
    return {n: pooled[n] for n in dev_ids}, metrics


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
    (:func:`_wire_puts`)."""
    queues = queues or {}
    new_states, new_queues, metrics = dict(states), dict(queues), {}
    wire = [n for n in dev_ids if isinstance(backends[n],
                                             CompressedWireBackend)]
    done = {n: backends[n].hybrid_update(states[n], queues.get(n),
                                         dev_ids[n], grads[n])
            for n in dev_ids if n not in wire}
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
    table's index arrays (a dense table's plan or occurrence rows, a wire
    table's ids and their occurrence slots) are built on the host and
    uploaded in ONE copy; the tables behind the wire gather their
    occurrence rows, compress in ONE launch and decompress in ONE; then
    every table pools in ONE bag launch (``unique_bag`` through a plan,
    ``embedding_bag`` at occurrence width and behind the wire).
    Read-only."""
    host, info = {}, {}
    for n, x in ids.items():
        b = backends[n]
        if isinstance(b, CompressedWireBackend):
            arr = _host_ids(x)
            if arr.ndim != 2:
                raise ValueError(f"read_pooled takes (B, L) bags, got "
                                 f"shape {arr.shape}")
            # negatives stay padding and ids past int32 stay out of range
            clipped = np.clip(arr, -1, _INT32_MAX)
            host[n] = [clipped, _host_slots(clipped)]
            c = _n_distinct(arr.reshape(-1), b.spec.rows)
        else:
            host[n], c = b._read_host(x)
        info[n] = {"reads": c, "hits": c, "misses": 0}
    flat = iter(upload_int32([a for arrs in host.values() for a in arrs],
                             device))
    idx = {n: [next(flat) for _ in arrs] for n, arrs in host.items()}
    bags, wire = {}, {}
    for n, got in idx.items():
        b, table = backends[n], states[n]["table"]
        if isinstance(b, CompressedWireBackend):
            rows, _ = b.inner._lookup_flat(states[n], got[0])
            wire[n] = (rows.float().contiguous(), b._block)
        elif len(got) == 2:
            bags[n] = (table, got[1], got[0], False)
        else:
            bags[n] = (table, None, got[0], True)
    for n, rows in _roundtrip_all(wire).items():
        bags[n] = (rows.reshape(-1, rows.shape[-1]), None, idx[n][1], True)
    pooled = _bag_all(bags)
    return {n: pooled[n] for n in ids}, info
