"""Embedding storage backends (port of ``repro/core/backend.py``): the
protocol base and the device-resident ``DenseBackend``.

The serving path reads each table through :meth:`EmbeddingBackend.
read_pooled`, which returns the table's sum-pooled bags straight from the
CUDA kernels: with ``spec.batch_dedup`` (the default) the host builds a
:class:`~repro_torch.core.dedup.DedupPlan` and ``unique_bag`` gathers,
scatters and pools at unique width; without it ``embedding_bag`` pools at
occurrence width. That is the trainer's own choice between plan and flat
ids in the JAX package (``prepare_all``), applied to the read.

The training path: ``prepare_all`` builds every table's plan on the host
and uploads all of the plans' index arrays in one copy; ``lookup_all``
reads the pooled bags through ``unique_bag``; ``put_all`` runs each
table's put through the ``fused_backward`` kernel, which segment-sums the
occurrence gradients, applies the row-wise optimizer to the put that pops
out of the staleness queue (or to its own sums in sync mode) and returns
the payload pushed into the queue. The puts update the tables, their
accumulators and the queues in place (the JAX trainer donates them).

The host-cached, sharded and compressed-wire backends, and training on
``batch_dedup=False`` tables (which needs ``dedup_put``), come with later
slices.
"""
from __future__ import annotations

import math

import numpy as np
import torch

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


def flat_training_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} has batch_dedup=False: training at occurrence width needs "
        "dedup_put (core/compression.py), which the torch port does not "
        "have yet — train with batch_dedup=True (the default)")


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
        raise flat_training_not_ported("this table")

    def _hybrid_flat(self, state, queue, dev_ids, grads):
        raise flat_training_not_ported("this table")

    def _put_unique(self, state, dev_u, g_u):
        """Pre-deduped put: (U,) unique device ids + (U, dim) fp32 summed
        grads."""
        raise NotImplementedError

    def _hybrid_unique(self, state, queue, dev_u, g_u):
        raise NotImplementedError


def _fused_backward(spec: EmbeddingSpec, state: dict, plan, grads,
                    apply_idx: torch.Tensor, apply_g, *,
                    apply_self: bool = False):
    """One-pass plan-driven put through the ``fused_backward`` kernel:
    segment-sum the occurrence grads along the plan's occurrence CSR, apply
    the optimizer row-wise at ``apply_idx`` (-1 = no-op) in place, return
    ``(state, g_push)`` with ``g_push`` the queue-ready (cap, dim) payload.
    Adagrad updates ``acc``; sgd (no ``acc``) is the plain scaled step."""
    order, offsets = plan.order, plan.offsets
    if order is None:
        o, f = D.occurrence_csr(plan.inv.cpu().numpy(), plan.dev.shape[0])
        order, offsets = (torch.from_numpy(a).to(plan.inv.device)
                          for a in (o, f))
    acc = state.get("acc") if spec.optimizer == "adagrad" else None
    g_push = K.fused_backward(
        state["table"], acc, order, offsets,
        grads.reshape(-1, spec.dim).float().contiguous(), apply_idx, apply_g,
        lr=spec.lr, eps=spec.eps, apply_self=apply_self)
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

    def read_pooled(self, state, ids):
        arr = _host_ids(ids)
        if arr.ndim != 2:
            raise ValueError(f"read_pooled takes (B, L) bags, got shape "
                             f"{arr.shape}")
        spec, table = self.spec, state["table"]
        # the translation to physical rows runs on the host, beside the
        # plan; the device gets one index copy per array
        if spec.batch_dedup:
            cap = D.dedup_cap(max(arr.size, 1), self.dedup_rows())
            u_pad, inv, _, info = D.make_plan(arr, spec.rows, cap)
            rows = self._logical_to_pos(torch.from_numpy(u_pad))
            plan = D.DedupPlan(dev=torch.from_numpy(u_pad.astype(np.int32)),
                               inv=torch.from_numpy(inv).to(table.device),
                               rows=rows.to(table.device))
            pooled, _ = self.lookup_pooled(state, plan)
            n = info["n_unique"]
        else:
            pooled, _ = self.lookup_pooled(state, torch.from_numpy(arr))
            n = _n_distinct(arr.reshape(-1), spec.rows)
        return pooled, {"reads": n, "hits": n, "misses": 0}

    def _put_unique(self, state, dev_u, g_u):
        return PS.apply_put(state, self.spec, dev_u, g_u,
                            assume_unique=True), {}

    def _put_plan(self, state, plan, grads):
        new, _ = _fused_backward(self.spec, state, plan, grads,
                                 self._plan_rows(plan), None,
                                 apply_self=True)
        return new, {}

    def _hybrid_plan(self, state, queue, plan, grads):
        spec = self.spec
        if spec.staleness <= 0 or queue is None:
            st, m = self._put_plan(state, plan, grads)
            return st, queue, m
        # pop the tau-stale put first (the kernel reads the slot before it
        # is overwritten), fuse its apply with this step's segment-sum, then
        # push the fresh payload into the popped slot — queue_push_pop's
        # order
        ids_q, g_q = queue["ids"], queue["grads"]
        tau, cap = int(ids_q.shape[0]), int(ids_q.shape[1])
        ptr, U = int(queue["ptr"]), int(plan.dev.shape[0])
        if U > cap:
            raise ValueError(f"plan width {U} exceeds the queue width {cap}")
        new, g_push = _fused_backward(spec, state, plan, grads,
                                      self._logical_to_pos(ids_q[ptr]),
                                      g_q[ptr])
        ids_q[ptr, :U] = plan.dev
        ids_q[ptr, U:] = -1
        g_q[ptr] = g_push
        return new, dict(queue, ptr=(ptr + 1) % tau,
                         filled=min(int(queue["filled"]) + 1, tau)), {}

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


def check_backend_name(name: str | None) -> None:
    """Reject ``EmbeddingSpec.backend`` values the port does not have yet
    (the JAX package also has host_lru, +disk and +compressed)."""
    if (name or "dense").strip().lower() != "dense":
        raise ValueError(f"embedding backend {name!r} is not ported yet: "
                         "the torch port has 'dense' only")


def create_backend(spec: EmbeddingSpec) -> EmbeddingBackend:
    check_backend_name(spec.backend)
    return DenseBackend(spec)


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
    host, metrics = {}, {}
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
        rows = b._logical_to_pos(torch.from_numpy(dev_u)).numpy()
        order, offsets = D.occurrence_csr(inv, dev_u.shape[0])
        host[n] = [dev_u, inv, rows, order, offsets]
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
            offsets=got[4])
    return new_states, dev_ids, metrics


def _tag(metrics, name, table_metrics):
    for k, v in table_metrics.items():
        metrics[f"wire/{name}/{k}"] = v


def lookup_all(backends, states, dev_ids):
    """Per-table pooled lookups -> ({table: (B, dim) pooled}, metrics)."""
    pooled, metrics = {}, {}
    for n in dev_ids:
        if n not in backends:
            raise KeyError(f"ids for unknown table {n!r}; collection has "
                           f"{sorted(backends)}")
        pooled[n], m = backends[n].lookup_pooled(states[n], dev_ids[n])
        _tag(metrics, n, m)
    return pooled, metrics


def put_all(backends, states, queues, dev_ids, grads):
    """Per-table hybrid updates (push this step's put, apply the tau-stale
    one) -> (states, queues, metrics)."""
    queues = queues or {}
    new_states, new_queues, metrics = dict(states), dict(queues), {}
    for n in dev_ids:
        st, q, m = backends[n].hybrid_update(
            states[n], queues.get(n), dev_ids[n], grads[n])
        new_states[n], new_queues[n] = st, q
        _tag(metrics, n, m)
    return new_states, new_queues, metrics
