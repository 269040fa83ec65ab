"""The Persia hybrid training algorithm (port of ``repro/core/hybrid.py``,
paper Alg. 1 + Alg. 2).

One train step =
  (1) prepare (host): each table's ids become a dedup plan (unique ids,
      inverse, physical rows, occurrence CSR), uploaded in one copy;
  (2) lookup: each table's pooled bags through the ``unique_bag`` kernel
      (``embedding_bag`` for occurrence-width tables), from the (possibly
      tau-stale) tables                                     [Alg.1 forward]
  (3) dense forward/backward: the pooled (B, D) bags are autograd leaves,
      so one ``torch.autograd.grad`` gives the dense gradients and each
      table's pooled gradient; the occurrence gradient is the pooled one
      broadcast over the bag's valid slots (what autodiff through the JAX
      package's ``pool_bag`` gives), and the dense side steps with Adam
      (synchronously, or tau_d steps late in 'async')          [Alg.2]
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
  bag kernels, and the adapter's ``predict``/``loss`` consume pooled bags;
  the JAX version returns (B, L, D) occurrence activations and pools inside
  ``predict``. ``lookup`` still returns the occurrence activations, read by
  the plain gather.
* ``step`` and ``decomposed_step`` are one computation: the JAX package's
  fused jit and its three donated dispatches (lookup, dense step, put)
  compute the same function, and eager torch dispatches op by op either
  way. ``decomposed_fns`` returns the three stages.
* A step updates the tables, their accumulators and the staleness queues
  in place (the JAX step donates the state): the state passed in must not
  be used again. The dense parameters and optimizer moments are new
  tensors.
* ``TrainState.step``, the optimizer's ``t`` and the queues' ``ptr`` and
  ``filled`` are host ints (int32 scalars on the device in the JAX
  package; the checkpoint stores them in the JAX package's dtypes).
* Tables with ``batch_dedup=False`` read and put at occurrence width:
  the pooled lookup through ``embedding_bag``, the put grouped on the
  device and summed by ``fused_backward``. Tables behind the compressed
  wire (``backend="dense+compressed"``) roundtrip their gets and puts
  through the blockscale kernels. The pipelined trainer and the
  host-cached and sharded backends come with later slices.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import backend as BK
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

    def to(self, device) -> "TrainState":
        """A copy of the whole state on ``device`` (tensors copied, host
        ints kept): a snapshot that later in-place steps do not touch."""
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


def _queue_depth(q) -> int:
    return 0 if q is None else int(np.shape(q["ids"])[0])


def _migrate_queue_widths(backend, q):
    """Restore-time staleness-queue width migration (numpy blobs): the
    width follows from the blob's own width through the backend's capacity
    rule — idempotent, so unique-width blobs pass through unchanged, while
    occurrence-width blobs (written with ``batch_dedup=False``) are
    re-encoded by deduplicating each pending put on the host. (The JAX
    package's per-shard queues of its sharded router are not ported.)"""
    from repro_torch.core import dedup as DD
    if q is None:
        return None
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

    def init(self, seed: int = 0, batch_example=None) -> TrainState:
        """Random dense params and tables on ``self.device``, drawn from one
        ``torch.Generator`` seeded with ``seed`` (dense first, then the
        tables in collection order), a fresh optimizer state and empty
        queues. ``batch_example`` sizes the staleness queues and is
        required whenever any staleness is in play — without it tau>0 would
        silently train synchronously. The JAX package's ``jax.random``
        streams cannot be reproduced here: to start from a JAX state, use
        ``repro_torch.convert.state_from_numpy``."""
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
        emb = {n: self.backends[n].init(gen) for n in self.collection.names}
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
        ``batch_dedup=False`` tables) and uploaded in one copy."""
        ids = self.adapter.emb_ids(batch)
        emb, dev_ids, m = BK.prepare_all(self.backends, state.emb, ids,
                                         self.device)
        return state.replace(emb=emb), dev_ids, m

    # -- the step ----------------------------------------------------------------

    def decomposed_fns(self):
        """(lookup_fn, dense_step, emb_put) — the step's three stages:

        * ``lookup_fn(emb_states, dev_ids) -> (pooled, metrics)``;
        * ``dense_step(dense, opt, dense_queue, pooled, batch, step_no) ->
          (dense, opt, dense_queue, agrads, metrics)``;
        * ``emb_put(emb_states, queues, dev_ids, agrads) -> (emb_states,
          queues, metrics)``."""
        backends, adapter, mode = self.backends, self.adapter, self.mode

        def lookup_fn(emb_states, dev_ids):
            return BK.lookup_all(backends, emb_states, dev_ids)  # Alg.1 fwd

        def dense_step(dense, opt, dense_queue, pooled, batch, step_no):
            names = list(pooled)
            bags = {n: pooled[n].detach().requires_grad_(True) for n in names}
            params = tree_map(lambda p: p.detach().requires_grad_(True),
                              dense)
            flat = _insertion_leaves(params)
            with torch.enable_grad():                           # Alg.2
                loss, metrics = adapter.loss(params, bags, batch)
                grads = torch.autograd.grad(
                    loss, flat + [bags[n] for n in names])
            it = iter(grads[:len(flat)])
            dgrads = tree_map(lambda _: next(it), params)
            # the occurrence gradient: the pooled one on every valid slot
            # of the bag (autodiff through pool_bag), masked by the ids
            ids = adapter.emb_ids(batch)
            masks = BK.upload_int32(
                [(np.asarray(ids[n]) >= 0).astype(np.int32) for n in names],
                self.device)
            agrads = {n: grads[len(flat) + i][:, None, :]
                      * masks[i][..., None].float()
                      for i, n in enumerate(names)}
            lr = self.lr_fn(step_no) if self.lr_fn is not None else None
            if mode.dense_staleness > 0 and dense_queue is not None:
                dense_queue, dgrads = _dense_queue_push_pop(dense_queue,
                                                            dgrads)
            dense, opt = self.opt_update(dense, dgrads, opt, lr=lr)
            metrics = {k: v.detach() for k, v in metrics.items()}
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
