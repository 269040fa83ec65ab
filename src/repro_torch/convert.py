"""Carry train states across from and back to the JAX package.

``state_from_numpy`` takes a JAX state's arrays as numpy (parameters,
optimizer moments, tables with their accumulators, staleness queues, the
step) and builds the port's :class:`~repro_torch.core.hybrid.TrainState`,
so both packages compute the same function from the same start;
``state_to_numpy`` is the reverse, in the JAX package's dtypes (the step,
the optimizer's ``t`` and the queues' ``ptr``/``filled`` as int32). Tables
keep their physical (uniform-shuffled, padded) row layout: the two packages
place rows with the same ``shuffle_pos``, so a table is copied as it is.
The checkpoint format (``PersiaTrainer.save``/``restore``) goes through
these two functions. A host_lru table crosses as its checkpoint blob
(device cache, host store and slot map, :func:`table_from_numpy`): its
host tiers live in the backend, not in the train state. A table of the
sharded router crosses as a dict of its shards' states (``"s0"`` ..
``"s{k-1}"``, each as above) or as its shard-tagged checkpoint blob, and
its queues as a dict of the shards' queues, the JAX package's layout.

For the LM family, ``lm_dense_from_numpy`` carries the transformer's dense
parameters across (``repro.models.transformer.init_dense``'s tree, key for
key, stacked layers included) and ``emb_from_numpy`` one embedding table's
state (``backend.init``'s ``{"table", "acc"}``); ``state_from_numpy``
takes a ``PersiaTrainer(lm_adapter)`` state whole (the transformer tree,
Adam's moments shaped like it, the vocab table, its queue).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hybrid import PersiaTrainer, TrainState
from repro_torch.device import resolve_device
from repro_torch.utils import tree_leaves, tree_map


def _tensor(a, shape, what, device, dtype=torch.float32) -> torch.Tensor:
    a = np.asarray(a)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(a.shape)}, this trainer "
                         f"wants {tuple(shape)}")
    return torch.tensor(a, dtype=dtype, device=device)


def _as_like(tree, like):
    """``tree`` with ``like``'s dicts where it has lists: the checkpoint
    loader reads a dict whose keys are all digits (an LM's ``"stack":
    {"0": ...}``) back as a list, in both packages."""
    if isinstance(like, dict):
        if isinstance(tree, (list, tuple)):
            tree = {str(i): v for i, v in enumerate(tree)}
        if isinstance(tree, dict):
            return {k: _as_like(v, like[k]) if k in like else v
                    for k, v in tree.items()}
    if isinstance(like, list) and isinstance(tree, list):
        return [_as_like(a, b) for a, b in zip(tree, like)]
    return tree


def _like_dense(tree, dense, what, device, lead=()):
    """A numpy tree shaped like the dense params (plus ``lead`` axes) ->
    fp32 tensors."""
    return tree_map(lambda a, p: _tensor(a, lead + tuple(p.shape), what,
                                         device), _as_like(tree, dense),
                    dense)


def _queue_from_numpy(q, spec, device):
    """A staleness queue as numpy -> tensors (a host_lru queue's
    ``slots`` ride beside its ids; a router's queues shard by shard)."""
    if q is None:
        return None
    if "ids" not in q:
        return {k: _queue_from_numpy(v, spec, device) for k, v in q.items()}
    ids = np.asarray(q["ids"])
    out = {k: _tensor(q[k], ids.shape, f"queue {k}", device, torch.int32)
           for k in ("slots", "ids") if k in q}
    out.update(grads=_tensor(q["grads"], ids.shape + (spec.dim,),
                             "queue grads", device, spec.dtype),
               ptr=int(np.asarray(q["ptr"])),
               filled=int(np.asarray(q["filled"])))
    return out


def state_from_numpy(trainer: PersiaTrainer, dense_np: dict, emb_np: dict,
                     *, opt=None, emb_queue=None, dense_queue=None,
                     step: int = 0, device=None) -> TrainState:
    """``dense_np``: ``{"mlp": [{"w": (d_in, d_out), "b": (d_out,)}, ...]}``
    for a CTR trainer, the transformer's tree for an LM trainer
    (:func:`lm_dense_from_numpy`);
    ``emb_np``: ``{table: {"table": (padded_rows, dim), "acc":
    (padded_rows,)}}`` in the physical shuffled layout for a dense table,
    and for a host_lru table its checkpoint blob or restored cache (see
    :func:`table_from_numpy`); ``opt``: the
    optimizer state (``{"m", "v", "t"}`` for Adam; a fresh one when
    ``None``); ``emb_queue``: ``{table: {"ids", "grads", "ptr", "filled"} |
    None}`` (plus ``"slots"`` for host_lru; none when ``None``);
    ``dense_queue``: ``{"grads", "ptr",
    "filled"}`` or ``None``. Shapes are checked against the trainer's model
    and collection. ``device`` defaults to the trainer's."""
    device = trainer.device if device is None else resolve_device(device)
    dense = _dense_from_numpy(trainer.adapter, dense_np, device)
    if set(emb_np) != set(trainer.collection.names):
        raise ValueError(f"tables {sorted(emb_np)} do not match the "
                         f"collection {sorted(trainer.collection.names)}")
    emb = {n: table_from_numpy(trainer.backends[n], emb_np[n], device,
                               f"{n}.")
           for n in trainer.collection.names}
    if opt is None:
        opt = trainer.opt_init(dense)
    else:
        opt = {k: int(np.asarray(v)) if k == "t"
               else _like_dense(v, dense, f"opt.{k}", device)
               for k, v in opt.items()}
    emb_queue = emb_queue or {}
    queues = {n: _queue_from_numpy(emb_queue.get(n), spec, device)
              for n, spec in trainer.collection.items()}
    if dense_queue is not None:
        tau = int(np.shape(tree_leaves(dense_queue["grads"])[0])[0])
        dense_queue = {
            "grads": _like_dense(dense_queue["grads"], dense,
                                 "dense_queue.grads", device, (tau,)),
            "ptr": int(np.asarray(dense_queue["ptr"])),
            "filled": int(np.asarray(dense_queue["filled"]))}
    return TrainState(dense=dense, opt=opt, emb=emb, emb_queue=queues,
                      dense_queue=dense_queue, step=int(np.asarray(step)))


def _dense_from_numpy(adapter, dense_np: dict, device) -> dict:
    """The dense parameters as numpy -> tensors, checked against the
    adapter's model: the CTR FFNN's ``{"mlp": [...]}`` or an LM's
    transformer tree (:func:`lm_dense_from_numpy`)."""
    if adapter.cfg.arch_type != "recsys":
        return lm_dense_from_numpy(dense_np, adapter.cfg, device)
    want = adapter.init_dense(torch.Generator(device="cpu").manual_seed(0))
    if len(dense_np["mlp"]) != len(want["mlp"]):
        raise ValueError(f"{len(dense_np['mlp'])} MLP layers, this trainer "
                         f"has {len(want['mlp'])}")
    return {"mlp": [
        {k: _tensor(lyr[k], ref[k].shape, f"mlp[{i}].{k}", device)
         for k in ("w", "b")}
        for i, (lyr, ref) in enumerate(zip(dense_np["mlp"], want["mlp"]))]}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _ring_to_numpy(q):
    """A staleness or delay queue as numpy; ptr/filled as int32 (a
    router's queues shard by shard)."""
    if q is None:
        return None
    if "ptr" not in q:
        return {k: _ring_to_numpy(v) for k, v in q.items()}
    out = {k: tree_map(_np, v) for k, v in q.items()
           if k not in ("ptr", "filled")}
    out["ptr"] = np.asarray(q["ptr"], np.int32)
    out["filled"] = np.asarray(q["filled"], np.int32)
    return out


def state_to_numpy(state: TrainState) -> dict:
    """The state as numpy trees: ``{"dense", "opt", "emb", "emb_queue",
    "dense_queue", "step"}``, in the JAX package's layout and dtypes."""
    opt = None if state.opt is None else {
        k: np.asarray(v, np.int32) if k == "t" else tree_map(_np, v)
        for k, v in state.opt.items()}
    return {
        "dense": tree_map(_np, state.dense),
        "opt": opt,
        "emb": tree_map(_np, state.emb),
        "emb_queue": {n: _ring_to_numpy(q)
                      for n, q in (state.emb_queue or {}).items()},
        "dense_queue": _ring_to_numpy(state.dense_queue),
        "step": np.asarray(state.step, np.int32),
    }


def lm_dense_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The JAX package's LM dense parameters (``transformer.init_dense``'s
    tree as numpy) -> fp32 tensors on ``device`` (the card by default).
    Keys and shapes are checked against the port's own init for ``cfg``
    (drawn on the meta device, so nothing is allocated)."""
    from repro_torch.models import transformer as T
    device = resolve_device("cuda" if device is None else device)
    want = T.init_dense(cfg, torch.Generator(device="cpu"),
                        device=torch.device("meta"))
    tree = _as_like(tree, want)

    def walk(a, w, path):
        if isinstance(w, dict):
            if not isinstance(a, dict) or set(a) != set(w):
                got = sorted(a) if isinstance(a, dict) else type(a).__name__
                raise ValueError(f"{path or 'params'}: keys {got}, this "
                                 f"model has {sorted(w)}")
            return {k: walk(a[k], w[k], f"{path}/{k}") for k in w}
        return _tensor(a, w.shape, path, device)

    return walk(tree, want, "")


def emb_from_numpy(emb_np: dict, spec, device=None) -> dict:
    """One embedding table's state as numpy (``{"table": (padded_rows,
    dim), "acc": (padded_rows,)}`` for adagrad, the physical shuffled
    layout) -> tensors on ``device`` (the card by default)."""
    return _emb_state(emb_np, spec,
                      resolve_device("cuda" if device is None else device))


def table_from_numpy(backend, emb_np: dict, device, what: str = "") -> dict:
    """One table's state as numpy -> tensors on ``device``, for the
    table's backend. Dense: ``{"table", "acc"}`` in the physical layout.
    host_lru: the JAX package's (or the port's) checkpoint blob
    ``{"cache", "store", "cache_meta"}``, whose host tiers (store, slot
    map, counters) are loaded into ``backend`` and whose device cache is
    returned, or a cache ``{"table", "slot_ids", "acc"}`` that the backend
    has already restored. A router: its shard-tagged checkpoint blob, or
    ``{"s0": .., "s{k-1}": ..}``, one of the above per shard. A remote
    table (``repro_torch.net.remote``): any of these is restored into its
    PS processes, and its remote state is returned."""
    from repro_torch.core.backend import (HostLRUBackend, ShardedBackend,
                                          unwrap)
    inner = unwrap(backend)
    if inner.remote:
        return inner.adopt(emb_np)
    if isinstance(inner, ShardedBackend):
        if "shard_meta" in emb_np:
            emb_np = inner.restore_from_checkpoint(emb_np)
        return {f"s{s}": table_from_numpy(sub, emb_np[f"s{s}"], device,
                                          f"{what}s{s}.")
                for s, sub in enumerate(inner.shard_backends)}
    if not isinstance(inner, HostLRUBackend):
        return _emb_state(emb_np, backend.spec, device, what)
    if "store" in emb_np:
        emb_np = inner.restore_from_checkpoint(emb_np)
    spec, n = inner.spec, inner.dev_slots
    st = {"table": _tensor(emb_np["table"], (n, spec.dim), f"{what}table",
                           device).to(spec.dtype),
          "slot_ids": _tensor(emb_np["slot_ids"], (n,), f"{what}slot_ids",
                              device, torch.int32)}
    if spec.optimizer == "adagrad":
        st["acc"] = _tensor(emb_np["acc"], (n,), f"{what}acc", device)
    return st


def _emb_state(emb_np: dict, spec, device, what: str = "") -> dict:
    # a table drawn with its rows padded for k shards (the legacy meaning
    # of init(emb_shards=k) on a dense table) keeps its padding
    rows = max(spec.padded_rows(1), int(np.shape(emb_np["table"])[0]))
    st = {"table": _tensor(emb_np["table"], (rows, spec.dim),
                           f"{what}table", device).to(spec.dtype)}
    if spec.optimizer == "adagrad":
        st["acc"] = _tensor(emb_np["acc"], (rows,), f"{what}acc", device)
    return st
