"""The Persia hybrid training algorithm (port of ``repro/core/hybrid.py``,
paper Alg. 1 + Alg. 2).

One train step =
  (1) prepare (host): each table's ids become a dedup plan (unique ids,
      inverse, table rows, occurrence CSR), uploaded in one copy; a
      host_lru table first faults its missing rows into its device cache
      (writing the evicted ones back to its host store), and its plan's
      device ids and rows are cache slots;
  (2) lookup: every table's pooled bags through ONE launch of the bag
      kernel (``unique_bag`` through a plan, ``embedding_bag`` for
      occurrence-width tables), from the (possibly tau-stale) tables; for
      an adapter whose loss takes occurrence activations (the LM), each
      table's unique rows gathered and scattered through the plan's
      inverse                                                [Alg.1 forward]
  (3) dense forward/backward: the pooled (B, D) bags (or the activations)
      are autograd leaves, so one ``torch.autograd.grad`` gives the dense
      gradients and each table's activation gradient; a pooled bag's
      occurrence gradient is its gradient broadcast over the bag's valid
      slots (what autodiff through the JAX package's ``pool_bag`` gives),
      and the dense side steps with Adam (synchronously, or tau_d steps
      late in 'async')                                        [Alg.2]
  (4) put: each table's occurrence gradients go through the
      ``fused_backward`` kernel, which segment-sums them to unique width,
      applies row-wise adagrad to the put that pops out of the bounded-
      staleness queue (from step t - tau; its own sums when tau = 0) and
      returns the payload pushed into the queue          [Alg.1 backward]
No (rows, D) table gradient is ever formed.

Three modes reproduce the paper's comparison:
  * hybrid — emb staleness tau>0, dense sync              (Persia)
  * sync   — tau=0 everywhere                              (XDL-sync analog)
  * async  — emb stale AND dense grads applied tau_d steps late

Differences from the JAX package, all of eager PyTorch:

* ``serve_lookup`` returns each table's sum-pooled (B, D) bags, read by the
  bag kernels, and a ``pooled`` adapter's ``predict``/``loss`` (the CTR
  ones) consume pooled bags; the JAX version returns (B, L, D) occurrence
  activations and pools inside ``predict``. ``lookup`` still returns the
  occurrence activations, read by the plain gather, and an adapter that is
  not ``pooled`` (the LM's) trains and evaluates on them, as in the JAX
  package.
* ``step`` and ``decomposed_step`` are one computation: the JAX package's
  fused jit and its three donated dispatches (lookup, dense step, put)
  compute the same function, and eager torch dispatches op by op either
  way. ``decomposed_fns`` returns the three stages.
* A step updates the tables, their accumulators, the staleness queues,
  the dense parameters and the optimizer moments in place (the JAX step
  donates the state): the state passed in must not be used again.
* ``TrainState.step``, the optimizer's ``t`` and the queues' ``ptr`` and
  ``filled`` are host ints (int32 scalars on the device in the JAX
  package; the checkpoint stores them in the JAX package's dtypes).
* Tables with ``batch_dedup=False`` read and put at occurrence width:
  the pooled lookup through ``embedding_bag`` (in the stage's one bag
  launch), the put grouped on the device and summed by
  ``fused_backward``. Tables behind the compressed wire
  (``backend="dense+compressed"``) roundtrip their gets and puts through
  the blockscale kernels, one compress and one decompress launch for all
  of them per get and per put. The pipelined trainer is
  ``core/pipeline.py``. A table of the sharded router
  (``emb_shards > 1``, or ``init(emb_shards=)``) pools in the same one bag
  launch (its shards' unique rows gathered into one block) and puts
  through one sum-only ``fused_backward`` launch and one apply-only launch
  per shard.
* A host_lru table's host tiers (store, slot map, counters) live in its
  backend, not in the ``TrainState``: ``TrainState.to`` copies the device
  cache only, and a copy that must train on its own needs its own
  trainer, carried across as a checkpoint blob (``convert``).
* ``eval``, ``predict`` and ``lookup`` read through the read-only serve
  path, as in the JAX package: a host_lru table's misses are read from
  its host store, never faulted in.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import backend as BK
from repro_torch.core import embedding_ps as PS
from repro_torch.core.collection import EmbeddingCollection
from repro_torch.device import resolve_device
from repro_torch.utils import tree_leaves, tree_map


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

    ``emb_ids`` maps a batch to a dict of per-table id arrays keyed by the
    collection's table names. With ``pooled`` (the CTR adapters),
    ``loss``/``predict`` receive the matching dict of pooled (B, D) bags,
    read by the bag kernels, and the trainer expands each bag's gradient
    over its valid slots; without it (the LM adapter), ``loss`` receives
    the per-occurrence activations (*ids.shape, D), as the JAX package
    hands every loss, and their gradient goes to the put unchanged.
    ``init_dense`` takes a ``torch.Generator`` and draws on its device.
    """
    cfg: Any
    collection: EmbeddingCollection
    init_dense: Callable[[torch.Generator], Any]
    emb_ids: Callable[[dict], dict]
    loss: Callable[[Any, dict, dict], tuple]
    predict: Optional[Callable] = None       # (dense, pooled, batch) -> preds
    pooled: bool = True


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

    def to(self, device) -> "TrainState":
        """A copy of the whole state on ``device`` (tensors copied, host
        ints kept): a snapshot that later in-place steps do not touch. A
        host_lru table's host tiers are not in the state: they stay with
        its backend."""
        dev = torch.device(device)
        cp = lambda x: x.to(dev, copy=True) \
            if isinstance(x, torch.Tensor) else x  # noqa: E731
        return TrainState(dense=tree_map(cp, self.dense),
                          opt=tree_map(cp, self.opt),
                          emb=tree_map(cp, self.emb),
                          emb_queue=tree_map(cp, self.emb_queue),
                          dense_queue=tree_map(cp, self.dense_queue),
                          step=self.step)


# -- dense gradient delay queue (async baseline) ------------------------------

def _dense_queue_init(dense, tau: int):
    return {
        "grads": tree_map(lambda p: torch.zeros((tau,) + tuple(p.shape),
                                                dtype=torch.float32,
                                                device=p.device), dense),
        "ptr": 0,
        "filled": 0,
    }


def _dense_queue_push_pop(queue, grads):
    """Push this step's dense grads into the slot at ``ptr`` (in place) and
    return the grads pushed tau_d steps ago; during warmup (the queue not
    yet full) the fresh grads are applied."""
    ptr, filled = int(queue["ptr"]), int(queue["filled"])
    n_tau = tree_leaves(queue["grads"])[0].shape[0]
    warm = filled < n_tau
    old = tree_map(lambda q, g: g.float() if warm else q[ptr].clone(),
                   queue["grads"], grads)
    for q, g in zip(tree_leaves(queue["grads"]), tree_leaves(grads)):
        q[ptr].copy_(g)
    return dict(queue, ptr=(ptr + 1) % n_tau,
                filled=min(filled + 1, n_tau)), old


def _queue_leaf(q):
    """The (tau, W) ``ids`` of a staleness queue, reaching into a sharded
    router's per-shard queues (``{"s0": {...}, ...}``)."""
    if q is None:
        return None
    return q["ids"] if "ids" in q else q["s0"]["ids"]


def _queue_depth(q) -> int:
    ids = _queue_leaf(q)
    return 0 if ids is None else int(np.shape(ids)[0])


def _queue_width(q) -> int:
    ids = _queue_leaf(q)
    return 0 if ids is None else int(np.prod(np.shape(ids)[1:]))


def _migrate_queue_widths(backend, q):
    """Restore-time staleness-queue width migration (numpy blobs): the
    width follows from the blob's own width through the backend's capacity
    rule — idempotent, so unique-width blobs pass through unchanged, while
    occurrence-width blobs (written with ``batch_dedup=False``) are
    re-encoded by deduplicating each pending put on the host. A router's
    per-shard queues migrate one by one."""
    from repro_torch.core import dedup as DD
    if q is None:
        return None
    if "ids" not in q:                  # the sharded router's queues
        return {k: _migrate_queue_widths(backend, v) for k, v in q.items()}
    saved = int(np.shape(q["ids"])[1])
    new_w = int(backend.queue_width(saved))
    if new_w == saved:
        return q
    return DD.migrate_queue_blob(q, new_w)


def _emb_grad_norm(agrads: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in agrads.values()))


def _insertion_leaves(tree) -> list:
    """Leaves in ``tree_map``'s walk order (dict insertion order)."""
    out: list = []
    tree_map(out.append, tree)
    return out


def _loss_grads(loss_fn, dense, acts: dict, batch):
    """``loss_fn(dense, acts, batch)`` and its gradients, with the dense
    parameters and each table's activations as autograd leaves ->
    ``(metrics, dense grads, {table: activation grad})``; the metrics
    detached."""
    names = list(acts)
    leaves = {n: acts[n].detach().requires_grad_(True) for n in names}
    params = tree_map(lambda p: p.detach().requires_grad_(True), dense)
    flat = _insertion_leaves(params)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, leaves, batch)
        grads = torch.autograd.grad(loss, flat + [leaves[n] for n in names])
    it = iter(grads[:len(flat)])
    dgrads = tree_map(lambda _: next(it), params)
    return ({k: v.detach() for k, v in metrics.items()}, dgrads,
            dict(zip(names, grads[len(flat):])))


# =============================================================================
# PersiaTrainer — the unified facade
# =============================================================================

class PersiaTrainer:
    """One object owning the model, its tables, where they live and the
    hybrid training loop.

    >>> trainer = PersiaTrainer(adapter, TrainMode.hybrid(3),
    ...                         OptConfig(kind="adam", lr=3e-3))  # on the card
    >>> state = trainer.init(seed=0, batch_example=batch)
    >>> state, metrics = trainer.step(state, batch)      # tables in place
    >>> metrics = trainer.eval(state, batch)
    >>> trainer.save(ckpt_dir, state)                    # full state
    >>> state = trainer.restore(ckpt_dir)

    ``opt`` is an ``OptConfig`` (default: Adam, lr 3e-4, clip 1.0) or an
    ``(opt_init, opt_update)`` pair; ``lr_fn(step)`` overrides its lr.
    ``device`` defaults to ``"cuda"`` and raises when no GPU is visible;
    pass ``"cpu"`` to run the plain torch path. By default every table's
    staleness is overridden by ``mode.emb_staleness`` (the JAX package's
    default); ``per_table_staleness=True`` honours each spec's own.
    ``batch_dedup=None`` honours each spec's flag; a bool overrides every
    table (True: plan + ``unique_bag``, False: occurrence width,
    ``embedding_bag``).
    """

    def __init__(self, adapter: ModelAdapter, mode: TrainMode | None = None,
                 opt: Any = None, lr_fn=None,
                 per_table_staleness: bool = False,
                 batch_dedup: bool | None = None,
                 device: str | torch.device = "cuda"):
        from repro_torch.optim.optimizers import OptConfig, make_optimizer
        self.device = resolve_device(device)
        self.adapter = adapter
        self.mode = mode or TrainMode.hybrid()
        if opt is None:
            opt = OptConfig()
        if isinstance(opt, OptConfig):
            self.opt_init, self.opt_update = make_optimizer(opt)
        else:
            self.opt_init, self.opt_update = opt
        self.lr_fn = lr_fn
        if per_table_staleness:
            self.collection = adapter.collection
        else:
            self.collection = adapter.collection.with_staleness(
                self.mode.emb_staleness)
        if batch_dedup is not None:
            self.collection = self.collection.map_specs(
                lambda _, s: dataclasses.replace(s, batch_dedup=batch_dedup))
        self.backends = self.collection.make_backends()

    # -- init -----------------------------------------------------------------

    def init(self, seed: int = 0, batch_example=None,
             emb_shards=1) -> TrainState:
        """Random dense params and tables on ``self.device``, drawn from one
        ``torch.Generator`` seeded with ``seed`` (dense first, then the
        tables in collection order), a fresh optimizer state and empty
        queues. ``batch_example`` sizes the staleness queues and is
        required whenever any staleness is in play — without it tau>0 would
        silently train synchronously. The JAX package's ``jax.random``
        streams cannot be reproduced here: to start from a JAX state, use
        ``repro_torch.convert.state_from_numpy``.

        ``emb_shards`` (an int or a ``{table: k}`` mapping, validated
        against the collection) sets per-table embedding-PS shard counts:
        host-backed tables (and routers of another count) are rebuilt as
        ``ShardedBackend`` routers of k shards; dense tables whose spec has
        no ``emb_shards`` keep the legacy meaning (their rows padded to a
        multiple of k). A table whose spec already has ``emb_shards > 1``
        is a router from construction; the default 1 never undoes it."""
        # swap the routers in BEFORE drawing the state
        self.collection._check_shard_mapping(emb_shards)
        for n in self.collection.names:
            self.backends[n] = BK.ensure_shards(
                self.backends[n], self.collection._shards_for(n, emb_shards))
        max_tau = max((s.staleness for _, s in self.collection.items()),
                      default=0)
        if batch_example is None and \
                (max_tau > 0 or self.mode.dense_staleness > 0):
            raise ValueError(
                "init() needs a batch_example to size the staleness queues "
                f"(emb tau up to {max_tau}, dense tau_d="
                f"{self.mode.dense_staleness})")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        dense = self.adapter.init_dense(gen)
        emb = {n: self.backends[n].init(
            gen, self.collection._shards_for(n, emb_shards))
            for n in self.collection.names}
        emb_queue = {n: None for n in self.collection.names}
        dense_queue = None
        if batch_example is not None:
            ids = self.adapter.emb_ids(batch_example)
            emb_queue.update({n: self.backends[n].queue_init(
                tuple(np.shape(a)), self.device) for n, a in ids.items()})
            if self.mode.dense_staleness > 0:
                dense_queue = _dense_queue_init(dense,
                                                self.mode.dense_staleness)
        return TrainState(dense=dense, opt=self.opt_init(dense), emb=emb,
                          emb_queue=emb_queue, dense_queue=dense_queue,
                          step=0)

    # -- the host-side prepare phase (batch dedup) -----------------------------

    def _prepare(self, state: TrainState, batch):
        """Returns (state, dev_ids, metrics): each table's ids deduplicated
        into a dedup plan on the host (kept at occurrence width for
        ``batch_dedup=False`` tables), host_lru rows faulted in, and the
        index arrays uploaded in one copy."""
        ids = self.adapter.emb_ids(batch)
        emb, dev_ids, m = BK.prepare_all(self.backends, state.emb, ids,
                                         self.device)
        return state.replace(emb=emb), dev_ids, m

    # -- the step ----------------------------------------------------------------

    def decomposed_fns(self):
        """(lookup_fn, dense_step, emb_put) — the step's three stages:

        * ``lookup_fn(emb_states, dev_ids) -> (acts, metrics)``: pooled
          (B, D) bags, or with an adapter that is not ``pooled`` the
          occurrence activations;
        * ``dense_step(dense, opt, dense_queue, acts, batch, step_no) ->
          (dense, opt, dense_queue, agrads, metrics)``;
        * ``emb_put(emb_states, queues, dev_ids, agrads) -> (emb_states,
          queues, metrics)``."""
        backends, adapter, mode = self.backends, self.adapter, self.mode

        def lookup_fn(emb_states, dev_ids):                     # Alg.1 fwd
            if adapter.pooled:
                return BK.lookup_all(backends, emb_states, dev_ids)
            return BK.lookup_occurrences_all(backends, emb_states, dev_ids)

        def dense_step(dense, opt, dense_queue, acts, batch, step_no):
            names = list(acts)
            metrics, dgrads, agrads = _loss_grads(adapter.loss, dense, acts,
                                                  batch)        # Alg.2
            if adapter.pooled:
                # the occurrence gradient: the pooled one on every valid
                # slot of the bag (autodiff through pool_bag), masked by
                # the ids
                ids = adapter.emb_ids(batch)
                masks = BK.upload_int32(
                    [(np.asarray(ids[n]) >= 0).astype(np.int32)
                     for n in names], self.device)
                agrads = {n: agrads[n][:, None, :]
                          * masks[i][..., None].float()
                          for i, n in enumerate(names)}
            lr = self.lr_fn(step_no) if self.lr_fn is not None else None
            if mode.dense_staleness > 0 and dense_queue is not None:
                dense_queue, dgrads = _dense_queue_push_pop(dense_queue,
                                                            dgrads)
            dense, opt = self.opt_update(dense, dgrads, opt, lr=lr)
            metrics["emb_grad_norm"] = _emb_grad_norm(agrads)
            return dense, opt, dense_queue, agrads, metrics

        def emb_put(emb_states, queues, dev_ids, agrads):    # Alg.1 bwd
            return BK.put_all(backends, emb_states, queues, dev_ids, agrads)

        return lookup_fn, dense_step, emb_put

    def train_step(self, state: TrainState, batch, dev_ids=None):
        """One step on prepared device ids (``_prepare`` runs first when
        ``dev_ids`` is None). Updates the tables and queues in place."""
        prep_m = {}
        if dev_ids is None:
            state, dev_ids, prep_m = self._prepare(state, batch)
        lookup_fn, dense_step, emb_put = self.decomposed_fns()
        pooled, get_metrics = lookup_fn(state.emb, dev_ids)
        dense, opt, dense_queue, agrads, metrics = dense_step(
            state.dense, state.opt, state.dense_queue, pooled, batch,
            state.step)
        emb, queues, put_metrics = emb_put(state.emb, state.emb_queue,
                                           dev_ids, agrads)
        metrics.update(prep_m)
        metrics.update(get_metrics)
        metrics.update(put_metrics)
        # host-side per-shard gauges (hit rates, faults, load imbalance)
        metrics.update(BK.shard_step_metrics(self.backends))
        return state.replace(dense=dense, opt=opt, emb=emb,
                             emb_queue=queues, dense_queue=dense_queue,
                             step=state.step + 1), metrics

    def step(self, state: TrainState, batch):
        """One step: the host prepare phase (batch dedup), then lookup,
        dense step and put. The tables and queues of ``state`` are updated
        in place: use only the returned state afterwards."""
        return self.train_step(state, batch)

    def decomposed_step(self, state: TrainState, batch):
        """The JAX package's three-dispatch step; in eager torch the same
        computation as :meth:`step`."""
        return self.train_step(state, batch)

    def run(self, state: TrainState, batches, steps: int | None = None,
            delay_fn=None) -> tuple[TrainState, list[dict]]:
        """Serial reference loop: one ``decomposed_step`` per batch
        (optionally capped at ``steps``), returning the final state and the
        per-step metrics. ``delay_fn(stage, step) -> seconds`` injects
        per-stage latencies, paid serially."""
        stages = ("loader", "prepare", "lookup", "dense", "put")
        metrics_list: list[dict] = []
        for idx, batch in enumerate(batches):
            if steps is not None and idx >= steps:
                break
            if delay_fn is not None:
                for stage in stages:
                    d = float(delay_fn(stage, idx))
                    if d > 0:
                        time.sleep(d)
            state, m = self.decomposed_step(state, batch)
            metrics_list.append(m)
        return state, metrics_list

    # -- eval / predict --------------------------------------------------------

    @torch.no_grad()
    def serve_lookup(self, state: TrainState, batch):
        """Read-path lookup (``backend.read_pooled_all``): logical ids ->
        per-table pooled (B, D) fp32 bags, read by the bag kernels (one
        ``unique_bag`` launch for every table read through a plan), without
        touching any backend state. Returns ``(pooled, info)`` with
        per-table ``{reads, hits, misses}`` read gauges."""
        return BK.read_pooled_all(self.backends, state.emb,
                                  self.adapter.emb_ids(batch), self.device)

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
        """Loss metrics (``loss``, and ``pred_mean`` or ``ppl_log``) on the
        current tables through the read-only serve path (pooled bags, or
        for an adapter that is not ``pooled`` the plain gather of
        :meth:`lookup`)."""
        if self.adapter.pooled:
            acts, _ = self.serve_lookup(state, batch)
        else:
            acts = self.lookup(state, batch)
        _, metrics = self.adapter.loss(state.dense, acts, batch)
        return metrics

    # -- checkpoint (full state, paper §4.2.4 policy) --------------------------
    #
    # The dense tree (params + optimizer + delay queue) is saved atomically;
    # the per-table PS states and staleness queues ride in the independent
    # embedding blob. The format is the JAX package's (same key paths and
    # dtypes), so checkpoints move between the two packages.

    def save(self, directory: str, state: TrainState,
             step: int | None = None) -> str:
        from repro_torch.checkpoint.ckpt import save_checkpoint
        from repro_torch.convert import state_to_numpy
        step = int(state.step) if step is None else int(step)
        tree = state_to_numpy(state)
        dense_tree = {"dense": tree["dense"], "opt": tree["opt"]}
        if tree["dense_queue"] is not None:
            dense_tree["dense_queue"] = tree["dense_queue"]
        emb_tree = {"emb": {n: BK.unwrap(self.backends[n])
                            .state_for_checkpoint(state.emb[n])
                            for n in state.emb},
                    "emb_queue": tree["emb_queue"]}
        return save_checkpoint(directory, step, dense_tree, emb_tree)

    def restore(self, directory: str, step: int | None = None) -> TrainState:
        from repro_torch.checkpoint.ckpt import load_checkpoint
        from repro_torch.convert import state_from_numpy
        step_no, dense_tree, emb_tree = load_checkpoint(directory, step)
        if not emb_tree or "emb" not in emb_tree or "dense" not in dense_tree:
            raise ValueError(
                f"checkpoint at {directory!r} is not a PersiaTrainer "
                "full-state snapshot (no per-table embedding blob)")
        want, got = set(self.collection.names), set(emb_tree["emb"])
        if want != got:
            raise ValueError(
                f"checkpoint tables {sorted(got)} do not match this "
                f"trainer's collection {sorted(want)}")
        emb = {}
        for n in self.collection.names:
            try:
                emb[n] = BK.unwrap(self.backends[n]) \
                    .restore_from_checkpoint(emb_tree["emb"][n])
            except ValueError as e:
                raise ValueError(f"checkpoint table {n!r}: {e}") from e
        queues = emb_tree.get("emb_queue", {})
        emb_queue = {n: queues.get(n) for n in self.collection.names}
        for n in self.collection.names:
            tau, q = self.collection[n].staleness, emb_queue[n]
            saved = _queue_depth(q)
            if (tau > 0) != (q is not None) or (q is not None
                                                and saved != tau):
                raise ValueError(
                    f"checkpoint table {n!r} was saved with staleness "
                    f"tau={saved} but this trainer runs tau={tau} — "
                    "restoring across modes would silently drop or bypass "
                    "the pending-put queue; rebuild the trainer with the "
                    "mode the checkpoint was trained under")
        for n in self.collection.names:
            if emb_queue[n] is not None and \
                    self.backends[n].last_restore_resharded:
                # the table was resharded on restore: its queued puts are
                # addressed in the OLD shard geometry (slots, local ids),
                # so they are dropped (the paper's tolerated in-flight
                # loss) and the queue restarts empty in the new geometry
                emb_queue[n] = self.backends[n].queue_init(
                    (_queue_width(emb_queue[n]),), "cpu")
        for n in self.collection.names:
            # occurrence-width queue blobs restore into a batch-dedup (or
            # wire) trainer by re-encoding each pending put at the width
            # this trainer's backend runs (queue_width)
            emb_queue[n] = _migrate_queue_widths(self.backends[n],
                                                 emb_queue[n])
        dq = dense_tree.get("dense_queue")
        tau_d = self.mode.dense_staleness
        dq_depth = 0 if dq is None else \
            int(tree_leaves(dq["grads"])[0].shape[0])
        if (tau_d > 0) != (dq is not None) or dq_depth not in (0, tau_d):
            raise ValueError(
                f"checkpoint was saved with dense staleness tau_d="
                f"{dq_depth} but this trainer runs tau_d={tau_d} — "
                "rebuild the trainer with the mode the checkpoint was "
                "trained under")
        return state_from_numpy(self, dense_tree["dense"], emb,
                                opt=dense_tree["opt"], emb_queue=emb_queue,
                                dense_queue=dq, step=step_no)


# =============================================================================
# Legacy single-table shims (pre-collection free-function API)
# =============================================================================
#
# The JAX package keeps these for adapters whose collection holds exactly
# one table (the LM family): a dict state, and the step built on the free
# functions of core/embedding_ps.py, whose put runs at occurrence width
# through the staleness queue (PS.queue_init((n_ids,))) and is grouped on
# the device when applied (one fused_backward launch).

def _sole_table(adapter: ModelAdapter):
    items = adapter.collection.items()
    if len(items) != 1:
        raise ValueError(
            "the legacy free-function API supports single-table adapters "
            f"only (got {len(items)} tables); use PersiaTrainer instead")
    return items[0]


def _ids_on(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids), device=device)


def init_train_state(adapter: ModelAdapter, mode: TrainMode, opt_init,
                     seed: int = 0, batch_example=None, emb_shards: int = 1,
                     device: str | torch.device = "cuda"):
    """``(state, spec)``: the dict state ``{"dense", "opt", "emb",
    "emb_queue", "dense_queue", "step"}`` on ``device``, dense parameters
    and then the table drawn from one ``torch.Generator`` seeded with
    ``seed`` (the JAX package takes a PRNG key), and the table's spec with
    the mode's staleness. ``batch_example`` sizes the queues;
    ``emb_shards`` pads the table's rows to a multiple of it (the JAX
    package's mesh padding)."""
    name, spec0 = _sole_table(adapter)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    dense = adapter.init_dense(gen)
    spec = dataclasses.replace(spec0, staleness=mode.emb_staleness)
    state = {"dense": dense, "opt": opt_init(dense),
             "emb": PS.ps_init(gen, spec, emb_shards), "emb_queue": None,
             "dense_queue": None, "step": 0}
    if batch_example is not None:
        n_ids = int(np.prod(np.shape(adapter.emb_ids(batch_example)[name])))
        if mode.emb_staleness > 0:
            state["emb_queue"] = PS.queue_init(spec, (n_ids,), spec.dim, dev)
        if mode.dense_staleness > 0:
            state["dense_queue"] = _dense_queue_init(dense,
                                                     mode.dense_staleness)
    return state, spec


def _put(state_emb, queue, spec, ids, agrads):
    return PS.hybrid_emb_update(state_emb, queue, spec, ids.reshape(-1),
                                agrads.reshape(-1, spec.dim))


def make_train_step(adapter: ModelAdapter, spec, mode: TrainMode,
                    opt_update, lr_fn=None):
    """``train_step(state, batch) -> (state, metrics)``: lookup, loss and
    gradients, the dense update (tau_d steps late in 'async'), and the
    embedding put through the queue. Updates ``state``'s tensors in
    place."""
    name, _ = _sole_table(adapter)

    def train_step(state, batch):
        ids = _ids_on(adapter.emb_ids(batch)[name],
                      state["emb"]["table"].device)
        acts = PS.lookup(state["emb"], spec, ids)             # Alg.1 fwd
        metrics, dgrads, agrads = _loss_grads(
            adapter.loss, state["dense"], {name: acts}, batch)
        lr = lr_fn(state["step"]) if lr_fn is not None else None
        dense_queue = state["dense_queue"]                   # Alg.2
        if mode.dense_staleness > 0 and dense_queue is not None:
            dense_queue, dgrads = _dense_queue_push_pop(dense_queue, dgrads)
        dense, opt = opt_update(state["dense"], dgrads, state["opt"], lr=lr)
        emb, emb_queue = _put(state["emb"], state["emb_queue"], spec, ids,
                              agrads[name])                  # Alg.1 bwd
        metrics["emb_grad_norm"] = _emb_grad_norm(agrads)
        return {"dense": dense, "opt": opt, "emb": emb,
                "emb_queue": emb_queue, "dense_queue": dense_queue,
                "step": state["step"] + 1}, metrics

    return train_step


def make_decomposed_fns(adapter: ModelAdapter, spec, mode: TrainMode,
                        opt_update, lr_fn=None):
    """The three stages of :func:`make_train_step`: ``lookup_fn(emb_state,
    ids) -> acts``, ``dense_step(dense, opt, acts, batch, step_no) ->
    (dense, opt, agrads, metrics)`` (the dense update is synchronous, as
    in the JAX package's) and ``emb_put(emb_state, queue, ids, agrads) ->
    (emb_state, queue)``."""
    name, _ = _sole_table(adapter)

    def lookup_fn(emb_state, ids):                           # Alg.1 fwd
        return PS.lookup(emb_state, spec,
                         _ids_on(ids, emb_state["table"].device))

    def dense_step(dense, opt, acts, batch, step_no):        # Alg.2
        metrics, dgrads, agrads = _loss_grads(adapter.loss, dense,
                                              {name: acts}, batch)
        lr = lr_fn(step_no) if lr_fn is not None else None
        dense, opt = opt_update(dense, dgrads, opt, lr=lr)
        return dense, opt, agrads[name], metrics

    def emb_put(emb_state, queue, ids, agrads):              # Alg.1 bwd
        return _put(emb_state, queue, spec,
                    _ids_on(ids, emb_state["table"].device), agrads)

    return lookup_fn, dense_step, emb_put


def decomposed_train_step(fns, state, batch, adapter):
    """One iteration through the decomposed stages."""
    name, _ = _sole_table(adapter)
    lookup_fn, dense_step, emb_put = fns
    ids = adapter.emb_ids(batch)[name]
    acts = lookup_fn(state["emb"], ids)
    dense, opt, agrads, metrics = dense_step(state["dense"], state["opt"],
                                             acts, batch, state["step"])
    emb, queue = emb_put(state["emb"], state["emb_queue"], ids, agrads)
    new_state = dict(state)
    new_state.update(dense=dense, opt=opt, emb=emb, emb_queue=queue,
                     step=state["step"] + 1)
    return new_state, metrics


def make_eval_step(adapter: ModelAdapter, spec):
    """``eval_step(state, batch) -> metrics`` on the current table."""
    name, _ = _sole_table(adapter)

    @torch.no_grad()
    def eval_step(state, batch):
        ids = _ids_on(adapter.emb_ids(batch)[name],
                      state["emb"]["table"].device)
        acts = PS.lookup(state["emb"], spec, ids)
        _, metrics = adapter.loss(state["dense"], {name: acts}, batch)
        return metrics
    return eval_step
