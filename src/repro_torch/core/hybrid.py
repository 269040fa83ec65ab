"""The Persia trainer facade (port of ``repro/core/hybrid.py``), serving
half: the train mode, the model adapter, the train state and the
``PersiaTrainer`` methods that read the state (``init``, ``serve_lookup``,
``lookup``, ``predict``, ``eval``).

The training methods (``step``, ``decomposed_step``, the puts, the
staleness queues, the dense optimizer, ``save``/``restore``) come with the
training slice; until then ``TrainState.opt`` and the queues are ``None``.

One difference from the JAX package: ``serve_lookup`` returns each table's
sum-pooled (B, D) bags, read through the bag kernels, and the adapter's
``predict``/``loss`` consume pooled bags. The JAX version returns (B, L, D)
occurrence activations and pools inside ``predict``. ``lookup`` still
returns the occurrence activations, read by the plain gather.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.core.collection import EmbeddingCollection
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class TrainMode:
    name: str = "hybrid"
    emb_staleness: int = 3
    dense_staleness: int = 0

    @staticmethod
    def hybrid(tau: int = 3) -> "TrainMode":
        return TrainMode("hybrid", tau, 0)

    @staticmethod
    def sync() -> "TrainMode":
        return TrainMode("sync", 0, 0)

    @staticmethod
    def async_(tau: int = 3, tau_dense: int = 3) -> "TrainMode":
        return TrainMode("async", tau, tau_dense)


@dataclass(frozen=True)
class ModelAdapter:
    """Bridges a concrete model family to the trainer.

    ``emb_ids`` maps a batch to a dict of per-table (B, L) id arrays keyed
    by the collection's table names; ``loss``/``predict`` receive the
    matching dict of pooled (B, D) bags. ``init_dense`` takes a
    ``torch.Generator`` and draws on its device.
    """
    cfg: Any
    collection: EmbeddingCollection
    init_dense: Callable[[torch.Generator], Any]
    emb_ids: Callable[[dict], dict]
    loss: Callable[[Any, dict, dict], tuple]
    predict: Optional[Callable] = None       # (dense, pooled, batch) -> preds


@dataclass
class TrainState:
    """Everything one run owns: dense params + optimizer, per-table PS
    states, per-table staleness queues, the async-dense delay queue, and
    the step counter."""
    dense: Any
    opt: Any
    emb: dict                  # name -> {"table", "acc"?}
    emb_queue: Any             # name -> staleness FIFO | None
    dense_queue: Any           # delay queue for 'async' mode | None
    step: int

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


class PersiaTrainer:
    """One object owning the model, its tables and where they live.

    >>> trainer = PersiaTrainer(adapter, TrainMode.sync())   # on the card
    >>> state = trainer.init(seed=0)
    >>> preds = trainer.predict(state, batch)
    >>> metrics = trainer.eval(state, batch)

    ``device`` defaults to ``"cuda"`` and raises when no GPU is visible;
    pass ``"cpu"`` to run the plain torch path. By default every table's
    staleness is overridden by ``mode.emb_staleness`` (the JAX package's
    default); ``per_table_staleness=True`` honours each spec's own.
    ``batch_dedup=None`` honours each spec's flag; a bool overrides every
    table (True: plan + ``unique_bag``, False: ``embedding_bag``).
    """

    def __init__(self, adapter: ModelAdapter, mode: TrainMode | None = None,
                 per_table_staleness: bool = False,
                 batch_dedup: bool | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.adapter = adapter
        self.mode = mode or TrainMode.hybrid()
        if per_table_staleness:
            self.collection = adapter.collection
        else:
            self.collection = adapter.collection.with_staleness(
                self.mode.emb_staleness)
        if batch_dedup is not None:
            self.collection = self.collection.map_specs(
                lambda _, s: dataclasses.replace(s, batch_dedup=batch_dedup))
        self.backends = self.collection.make_backends()

    def init(self, seed: int = 0) -> TrainState:
        """Random dense params and tables on ``self.device``, drawn from one
        ``torch.Generator`` seeded with ``seed`` (dense first, then the
        tables in collection order). The JAX package's ``jax.random``
        streams cannot be reproduced here: to start from a JAX state, use
        ``repro_torch.convert.state_from_numpy``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        dense = self.adapter.init_dense(gen)
        emb = {n: self.backends[n].init(gen) for n in self.collection.names}
        return TrainState(dense=dense, opt=None, emb=emb,
                          emb_queue={n: None for n in self.collection.names},
                          dense_queue=None, step=0)

    @torch.no_grad()
    def serve_lookup(self, state: TrainState, batch):
        """Read-path lookup (``EmbeddingBackend.read_pooled``): logical ids
        -> per-table pooled (B, D) fp32 bags, read by the bag kernels,
        without touching any backend state. Returns ``(pooled, info)``
        with per-table ``{reads, hits, misses}`` read gauges."""
        pooled, info = {}, {}
        for n, ids in self.adapter.emb_ids(batch).items():
            pooled[n], info[n] = self.backends[n].read_pooled(state.emb[n],
                                                              ids)
        return pooled, info

    @torch.no_grad()
    def lookup(self, state: TrainState, batch) -> dict:
        """Per-table occurrence activations (B, L, D), read by the plain
        gather (``EmbeddingBackend.read_rows``)."""
        return {n: self.backends[n].read_rows(state.emb[n], ids)[0]
                for n, ids in self.adapter.emb_ids(batch).items()}

    @torch.no_grad()
    def predict(self, state: TrainState, batch) -> torch.Tensor:
        if self.adapter.predict is None:
            raise ValueError("adapter has no predict fn")
        pooled, _ = self.serve_lookup(state, batch)
        return self.adapter.predict(state.dense, pooled, batch)

    @torch.no_grad()
    def eval(self, state: TrainState, batch) -> dict:
        """Loss metrics (``loss``, ``pred_mean``) on the current tables
        through the read-only serve path."""
        pooled, _ = self.serve_lookup(state, batch)
        _, metrics = self.adapter.loss(state.dense, pooled, batch)
        return metrics
