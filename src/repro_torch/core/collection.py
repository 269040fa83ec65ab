"""EmbeddingCollection — a registry of named embedding tables (port of
``repro/core/collection.py``).

Persia's production models (paper §4.1, Table 1) are built from many
heterogeneous ID feature groups; a collection maps table *names* to
independent :class:`~repro_torch.core.embedding_ps.EmbeddingSpec` s, and
the collection-level operations (``init`` / ``lookup`` / ``apply_put`` /
``queue_init`` / ``hybrid_update``) fan out to the per-table PS primitives
of ``core/embedding_ps.py``. All per-table state flows through plain dicts
keyed by table name:

    states : {name: {"table": (R, D), "acc": (R,)?}}       (PS shard state)
    ids    : {name: integer tensor, any shape, -1 = padding}
    acts   : {name: (*ids.shape, dim) activations}
    queues : {name: staleness FIFO or None}

As everywhere in the port, the puts update the states and queues in place
(the JAX package returns new arrays). The trainer itself reaches its
tables through their backends and the grouped fan-outs of
``core/backend.py`` (``prepare_all``, ``lookup_all``, ``put_all``).
``with_backward_kernel`` selects nothing (every put runs the
``fused_backward`` CUDA kernel), and ``with_shards`` takes only one shard
until the sharded router is ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Mapping

import torch

from repro_torch.core import embedding_ps as PS
from repro_torch.core.embedding_ps import EmbeddingSpec


@dataclass(frozen=True)
class EmbeddingCollection:
    """Ordered, immutable registry of named embedding tables."""

    tables: tuple[tuple[str, EmbeddingSpec], ...]

    def __post_init__(self):
        from repro_torch.core.backend import create_backend
        seen = set()
        for n, s in self.tables:
            # names key checkpoint blob paths in the JAX package: '/' would
            # split the path, and all-digit names read back as list indices
            if not n or "/" in n or n.isdigit():
                raise ValueError(
                    f"invalid table name {n!r}: names must be non-empty, "
                    "contain no '/', and not be all digits")
            if n in seen:
                raise ValueError(f"duplicate table name {n!r}")
            seen.add(n)
            create_backend(s)       # fail fast on bad or unported specs

    @staticmethod
    def from_dict(specs: Mapping[str, EmbeddingSpec]) -> "EmbeddingCollection":
        return EmbeddingCollection(tuple(specs.items()))

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.tables)

    @property
    def specs(self) -> dict[str, EmbeddingSpec]:
        return dict(self.tables)

    def items(self):
        return self.tables

    def __len__(self) -> int:
        return len(self.tables)

    def __iter__(self) -> Iterator[str]:
        return iter(self.names)

    def __contains__(self, name: str) -> bool:
        return any(n == name for n, _ in self.tables)

    def __getitem__(self, name: str) -> EmbeddingSpec:
        for n, s in self.tables:
            if n == name:
                return s
        raise KeyError(name)

    # -- derived sizes -------------------------------------------------------

    @property
    def total_rows(self) -> int:
        return sum(s.rows for _, s in self.tables)

    @property
    def total_params(self) -> int:
        return sum(s.rows * s.dim for _, s in self.tables)

    def map_specs(self, fn: Callable[[str, EmbeddingSpec], EmbeddingSpec]
                  ) -> "EmbeddingCollection":
        return EmbeddingCollection(tuple((n, fn(n, s)) for n, s in self.tables))

    def with_staleness(self, tau: int) -> "EmbeddingCollection":
        """Set every table's staleness to ``tau`` (mode-wide override)."""
        return self.map_specs(
            lambda _, s: dataclasses.replace(s, staleness=tau))

    def with_backend(self, backend: str,
                     cache_rows: int | None = None) -> "EmbeddingCollection":
        """Set every table's storage backend (collection-wide override),
        e.g. ``"dense+compressed"`` or ``"host_lru+disk"``; optionally also
        the host_lru device-cache size."""
        def fn(_, s):
            kw = {"backend": backend}
            if cache_rows is not None:
                kw["cache_rows"] = cache_rows
            return dataclasses.replace(s, **kw)
        return self.map_specs(fn)

    def with_store_dtype(self, store_dtype: str) -> "EmbeddingCollection":
        """Set every table's host-store row format (``"fp32"`` or the
        blockscale-compressed ``"blockscale16"``, core/lru.py)."""
        return self.map_specs(
            lambda _, s: dataclasses.replace(s, store_dtype=store_dtype))

    def with_backward_kernel(self, on: bool = True) -> "EmbeddingCollection":
        """Set every table's ``backward_kernel`` flag. In the JAX package it
        picks the Pallas fused backward over its jnp oracle; in the port it
        selects nothing, since every put runs the ``fused_backward`` CUDA
        kernel (its plain version on the CPU)."""
        return self.map_specs(
            lambda _, s: dataclasses.replace(s, backward_kernel=bool(on)))

    def with_shards(self, shards: "int | Mapping[str, int]"
                    ) -> "EmbeddingCollection":
        """Per-table embedding-PS shard counts: an int for every table, or
        a mapping of table names (validated). One shard is the collection
        as it is; more raise until the sharded router is ported."""
        self._check_shard_mapping(shards)
        ks = shards.values() if isinstance(shards, Mapping) else [shards]
        many = sorted({int(k) for k in ks if int(k) > 1})
        if many:
            raise NotImplementedError(
                f"{many[-1]} embedding shards: the sharded router is not "
                "ported yet (ROADMAP.md, Queue 1 item 4)")
        return self

    def make_backends(self):
        """One EmbeddingBackend per table (core/backend.py). Instances own
        mutable host state (a host_lru table's store and slot map): every
        trainer must build its own set."""
        from repro_torch.core.backend import make_backends
        return make_backends(self)

    # -- collection-level PS ops ---------------------------------------------

    def _check_shard_mapping(self, shards) -> None:
        if not isinstance(shards, Mapping):
            if int(shards) < 1:
                raise ValueError(f"emb_shards must be >= 1, got {shards}")
            return
        unknown = set(shards) - set(self.names)
        if unknown:
            raise ValueError(
                f"emb_shards names unknown tables {sorted(unknown)}; "
                f"collection has {list(self.names)}")
        bad = {n: k for n, k in shards.items() if int(k) < 1}
        if bad:
            raise ValueError(f"emb_shards must be >= 1, got {bad}")

    def init(self, generator: torch.Generator,
             shards: "int | Mapping[str, int]" = 1,
             scale: float = 0.02) -> dict[str, Any]:
        """Per-table PS state (table + row-wise optimizer accumulator),
        drawn from ``generator`` table after table on its device. The JAX
        package's ``jax.random`` split per table cannot be reproduced."""
        self.with_shards(shards)
        return {n: PS.ps_init(generator, s, 1, scale)
                for n, s in self.tables}

    def _check_ids(self, ids: Mapping[str, Any]) -> None:
        unknown = set(ids) - set(self.names)
        if unknown:
            raise KeyError(f"ids for unknown tables {sorted(unknown)}; "
                           f"collection has {list(self.names)}")

    def lookup(self, states: Mapping[str, Any], ids: Mapping[str, Any]
               ) -> dict[str, torch.Tensor]:
        """Batched per-table gets; ids of any shape -> (..., dim) acts."""
        self._check_ids(ids)
        return {n: PS.lookup(states[n], self[n], ids[n]) for n in ids}

    def apply_put(self, states: Mapping[str, Any], ids: Mapping[str, Any],
                  grads: Mapping[str, Any]) -> dict[str, Any]:
        """Apply activation-gradient puts table by table (each deduplicated
        on its physical rows), in place."""
        self._check_ids(ids)
        out = dict(states)
        for n in ids:
            spec = self[n]
            out[n] = PS.apply_put(states[n], spec, ids[n].reshape(-1),
                                  grads[n].reshape(-1, spec.dim))
        return out

    def queue_init(self, ids_shapes: Mapping[str, tuple],
                   device=None) -> dict[str, Any]:
        """Per-table staleness FIFOs at occurrence width (None for
        synchronous tables and tables without a shape), on ``device``."""
        out = {}
        for n, spec in self.tables:
            shape = ids_shapes.get(n)
            if shape is None or spec.staleness <= 0:
                out[n] = None
                continue
            n_ids = 1
            for s in shape:
                n_ids *= int(s)
            out[n] = PS.queue_init(spec, (n_ids,), spec.dim, device)
        return out

    def hybrid_update(self, states: Mapping[str, Any],
                      queues: Mapping[str, Any] | None,
                      ids: Mapping[str, Any], grads: Mapping[str, Any]
                      ) -> tuple[dict[str, Any], dict[str, Any]]:
        """One hybrid-algorithm update per table: push this step's put,
        apply the tau-stale put that pops out (tau=0 applies at once)."""
        self._check_ids(ids)
        queues = queues or {}
        new_states, new_queues = dict(states), dict(queues)
        for n in ids:
            spec = self[n]
            new_states[n], new_queues[n] = PS.hybrid_emb_update(
                states[n], queues.get(n), spec, ids[n].reshape(-1),
                grads[n].reshape(-1, spec.dim))
        return new_states, new_queues
