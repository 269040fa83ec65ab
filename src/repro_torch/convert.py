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
these two functions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hybrid import PersiaTrainer, TrainState
from repro_torch.device import resolve_device
from repro_torch.utils import tree_map


def _tensor(a, shape, what, device, dtype=torch.float32) -> torch.Tensor:
    a = np.asarray(a)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(a.shape)}, this trainer "
                         f"wants {tuple(shape)}")
    return torch.tensor(a, dtype=dtype, device=device)


def _like_dense(tree, dense, what, device, lead=()):
    """A numpy tree shaped like the dense params (plus ``lead`` axes) ->
    fp32 tensors."""
    return tree_map(lambda a, p: _tensor(a, lead + tuple(p.shape), what,
                                         device), tree, dense)


def _queue_from_numpy(q, spec, device):
    if q is None:
        return None
    ids = np.asarray(q["ids"])
    return {"ids": torch.tensor(ids, dtype=torch.int32, device=device),
            "grads": _tensor(q["grads"], ids.shape + (spec.dim,),
                             "queue grads", device, spec.dtype),
            "ptr": int(np.asarray(q["ptr"])),
            "filled": int(np.asarray(q["filled"]))}


def state_from_numpy(trainer: PersiaTrainer, dense_np: dict, emb_np: dict,
                     *, opt=None, emb_queue=None, dense_queue=None,
                     step: int = 0, device=None) -> TrainState:
    """``dense_np``: ``{"mlp": [{"w": (d_in, d_out), "b": (d_out,)}, ...]}``;
    ``emb_np``: ``{table: {"table": (padded_rows, dim), "acc":
    (padded_rows,)}}`` in the physical shuffled layout; ``opt``: the
    optimizer state (``{"m", "v", "t"}`` for Adam; a fresh one when
    ``None``); ``emb_queue``: ``{table: {"ids", "grads", "ptr", "filled"} |
    None}`` (none when ``None``); ``dense_queue``: ``{"grads", "ptr",
    "filled"}`` or ``None``. Shapes are checked against the trainer's model
    and collection. ``device`` defaults to the trainer's."""
    device = trainer.device if device is None else resolve_device(device)
    want = trainer.adapter.init_dense(
        torch.Generator(device="cpu").manual_seed(0))
    if len(dense_np["mlp"]) != len(want["mlp"]):
        raise ValueError(f"{len(dense_np['mlp'])} MLP layers, this trainer "
                         f"has {len(want['mlp'])}")
    dense = {"mlp": [
        {k: _tensor(lyr[k], ref[k].shape, f"mlp[{i}].{k}", device)
         for k in ("w", "b")}
        for i, (lyr, ref) in enumerate(zip(dense_np["mlp"], want["mlp"]))]}
    if set(emb_np) != set(trainer.collection.names):
        raise ValueError(f"tables {sorted(emb_np)} do not match the "
                         f"collection {sorted(trainer.collection.names)}")
    emb = {}
    for n, spec in trainer.collection.items():
        rows = spec.padded_rows(1)
        emb[n] = {"table": _tensor(emb_np[n]["table"], (rows, spec.dim),
                                   f"{n}.table", device).to(spec.dtype)}
        if spec.optimizer == "adagrad":
            emb[n]["acc"] = _tensor(emb_np[n]["acc"], (rows,), f"{n}.acc",
                                    device)
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
        tau = int(np.shape(dense_queue["grads"]["mlp"][0]["w"])[0])
        dense_queue = {
            "grads": _like_dense(dense_queue["grads"], dense,
                                 "dense_queue.grads", device, (tau,)),
            "ptr": int(np.asarray(dense_queue["ptr"])),
            "filled": int(np.asarray(dense_queue["filled"]))}
    return TrainState(dense=dense, opt=opt, emb=emb, emb_queue=queues,
                      dense_queue=dense_queue, step=int(np.asarray(step)))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _ring_to_numpy(q):
    """A staleness or delay queue as numpy; ptr/filled as int32."""
    if q is None:
        return None
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
