"""Embedding storage backends (port of ``repro/core/backend.py``): the
protocol base and the device-resident ``DenseBackend``.

The serving path reads each table through :meth:`EmbeddingBackend.
read_pooled`, which returns the table's sum-pooled bags straight from the
CUDA kernels: with ``spec.batch_dedup`` (the default) the host builds a
:class:`~repro_torch.core.dedup.DedupPlan` and ``unique_bag`` gathers,
scatters and pools at unique width; without it ``embedding_bag`` pools at
occurrence width. That is the trainer's own choice between plan and flat
ids in the JAX package (``prepare_all``), applied to the read.

The host-cached, sharded and compressed-wire backends and the training
puts come with later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dedup as D
from repro_torch.core import embedding_ps as PS
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.kernels import ops as K


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

    The lookup accepts device ids in two forms: a raw id tensor (one row
    per occurrence) or a :class:`~repro_torch.core.dedup.DedupPlan` (``dev``
    unique device ids + ``inv`` occurrence -> unique inverse), which
    gathers the unique rows and scatters them through the inverse."""

    spec: EmbeddingSpec

    def init(self, generator: torch.Generator, shards: int = 1,
             scale: float = 0.02):
        raise NotImplementedError

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

    def lookup(self, state, dev_ids):
        if D.is_plan(dev_ids):
            acts_u, m = self._lookup_unique(state, dev_ids.dev)
            return D.plan_scatter(acts_u, dev_ids.inv), m
        return self._lookup_flat(state, dev_ids)

    def _lookup_flat(self, state, dev_ids):
        raise NotImplementedError

    def _lookup_unique(self, state, dev_u):
        """(U,) unique device ids -> ((U, dim) rows, metrics). Default:
        the flat lookup already handles any id shape."""
        return self._lookup_flat(state, dev_u)


class DenseBackend(EmbeddingBackend):
    """Device-resident PS shard; device ids ARE the logical ids."""

    def __init__(self, spec: EmbeddingSpec):
        self.spec = spec

    def init(self, generator: torch.Generator, shards: int = 1,
             scale: float = 0.02):
        return PS.ps_init(generator, self.spec, shards, scale)

    def _lookup_flat(self, state, dev_ids):
        return PS.lookup(state, self.spec, dev_ids), {}

    def _logical_to_pos(self, ids: torch.Tensor) -> torch.Tensor:
        """Logical id -> physical shuffled row as int32; padding and ids
        out of range (< 0 or >= rows) become -1."""
        spec = self.spec
        valid = (ids >= 0) & (ids < spec.rows)
        pos = PS.shuffle_pos(torch.where(valid, ids, 0), spec.padded_rows(1))
        return torch.where(valid, pos, -1).to(torch.int32)

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
            dev = self._logical_to_pos(torch.from_numpy(u_pad))
            pooled = K.unique_bag(table, dev.to(table.device),
                                  torch.from_numpy(inv).to(table.device))
            n = info["n_unique"]
        else:
            pos = self._logical_to_pos(torch.from_numpy(arr))
            pooled = K.embedding_bag(table, pos.to(table.device))
            n = _n_distinct(arr.reshape(-1), spec.rows)
        return pooled, {"reads": n, "hits": n, "misses": 0}


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
