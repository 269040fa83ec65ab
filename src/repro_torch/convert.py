"""Carry weights across from the JAX package.

``state_from_numpy`` takes the JAX package's parameters as numpy arrays and
builds the port's :class:`~repro_torch.core.hybrid.TrainState`, so both
packages compute the same function. Tables keep their physical
(uniform-shuffled, padded) row layout: the two packages place rows with the
same ``shuffle_pos``, so a table is copied as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hybrid import PersiaTrainer, TrainState
from repro_torch.device import resolve_device


def _tensor(a, shape, what, device) -> torch.Tensor:
    a = np.asarray(a)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(a.shape)}, this trainer "
                         f"wants {tuple(shape)}")
    return torch.tensor(a, dtype=torch.float32, device=device)


def state_from_numpy(trainer: PersiaTrainer, dense_np: dict, emb_np: dict,
                     device=None) -> TrainState:
    """``dense_np``: ``{"mlp": [{"w": (d_in, d_out), "b": (d_out,)}, ...]}``;
    ``emb_np``: ``{table: {"table": (padded_rows, dim), "acc":
    (padded_rows,)}}`` in the physical shuffled layout. Shapes are checked
    against the trainer's model and collection. ``device`` defaults to the
    trainer's."""
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
    return TrainState(dense=dense, opt=None, emb=emb,
                      emb_queue={n: None for n in trainer.collection.names},
                      dense_queue=None, step=0)
