"""Checkpointing with Persia's fault-tolerance policy (port of
``repro/checkpoint/ckpt.py``, paper §4.2.4), in the JAX package's on-disk
format, so checkpoints move between the two packages:

* embedding PS shards are saved *independently* (an in-flight put lost on
  restore is tolerable — Alg.1 is lock-free anyway), each a flat blob of
  raw little-endian buffers (``data.bin``) plus a json manifest of key
  path, dtype, shape and offset;
* the dense model + optimizer state is saved *atomically* (write to a temp
  dir, fsync, rename) because any drop of dense synchronisation is vital.

The code is the JAX package's numpy code, copied; trees are nested dicts
and lists of numpy arrays (``repro_torch.convert.state_to_numpy`` makes
them from a train state). ``CheckpointManager`` saves every ``every``
steps and keeps the newest ``keep``. ``checkpoint_shard_layout`` reads
each table's shard count off a saved full-state checkpoint (1 for a plain
table, N for the sharded router's shard-tagged blob).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.utils import tree_map


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        pass
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, arr in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return _listify(root)


def _listify(node):
    if isinstance(node, dict):
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [_listify(node[str(i)]) for i in range(len(keys))]
        return {k: _listify(v) for k, v in node.items()}
    return node


def _write_blob(path: str, tree):
    flat = _flatten(tree)
    manifest = {}
    with open(os.path.join(path, "data.bin"), "wb") as f:
        off = 0
        for k in sorted(flat):
            a = np.asarray(flat[k])
            shape = list(a.shape)                  # before ascontiguousarray
            raw = np.ascontiguousarray(a).tobytes()   # zero-copy layout
            f.write(raw)
            manifest[k] = {"dtype": str(a.dtype), "shape": shape,
                           "offset": off, "nbytes": len(raw)}
            off += len(raw)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _read_blob(path: str):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    buf = np.memmap(os.path.join(path, "data.bin"), dtype=np.uint8, mode="r")
    flat = {}
    for k, m in manifest.items():
        raw = buf[m["offset"]: m["offset"] + m["nbytes"]]
        flat[k] = np.frombuffer(raw.tobytes(), dtype=m["dtype"]) \
            .reshape(m["shape"])
    return _unflatten(flat)


def save_checkpoint(directory: str, step: int, dense_tree, emb_tree=None):
    """Atomic dense save + independent embedding shard save."""
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_")
    try:
        dense_dir = os.path.join(tmp, "dense")
        os.makedirs(dense_dir)
        _write_blob(dense_dir, {"state": dense_tree,
                                "step": np.int64(step)})
        if emb_tree is not None:
            emb_dir = os.path.join(tmp, "emb")
            os.makedirs(emb_dir)
            _write_blob(emb_dir, emb_tree)
        final = os.path.join(directory, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        return final
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_checkpoint(directory: str, step: int | None = None):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_"))
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    dense = _read_blob(os.path.join(path, "dense"))
    emb = None
    if os.path.isdir(os.path.join(path, "emb")):
        emb = _read_blob(os.path.join(path, "emb"))
    return int(dense["step"]), dense["state"], emb


def checkpoint_shard_layout(directory: str, step: int | None = None
                            ) -> dict[str, int]:
    """Per-table embedding-PS shard counts of a saved full-state
    checkpoint: 1 for plain (unsharded) table blobs, N for shard-tagged
    router blobs. Raises if the checkpoint has no embedding blob."""
    _, _, emb = load_checkpoint(directory, step)
    if not emb or "emb" not in emb:
        raise ValueError(
            f"checkpoint at {directory!r} carries no per-table embedding "
            "blob (legacy save_checkpoint format?)")
    out = {}
    for name, blob in emb["emb"].items():
        if not isinstance(blob, dict) or \
                ("shard_meta" not in blob and "shards" not in blob):
            out[name] = 1                       # plain (unsharded) table blob
            continue
        if "shard_meta" not in blob or "shards" not in blob:
            missing = "shard_meta" if "shard_meta" not in blob else "shards"
            raise ValueError(
                f"table {name!r}: sharded checkpoint blob is missing its "
                f"{missing!r} entry — corrupt or truncated save")
        meta = np.asarray(blob["shard_meta"]).reshape(-1)
        if meta.size != 3 or not np.issubdtype(meta.dtype, np.integer) \
                or int(meta[0]) < 1:
            raise ValueError(
                f"table {name!r}: corrupt shard_meta {meta!r} (expected "
                "3 ints [n_shards, rows, dim] with n_shards >= 1)")
        k = int(meta[0])
        have = sorted(blob["shards"])
        want = [f"s{s}" for s in range(k)]
        if have != sorted(want):
            raise ValueError(
                f"table {name!r}: shard_meta declares {k} shards but the "
                f"blob holds {have} (expected {want})")
        out[name] = k
    return out


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class CheckpointManager:
    """Periodic saver with the paper's policy baked in."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep

    def maybe_save(self, step: int, dense_tree, emb_tree=None):
        """Save the trees (of tensors or arrays, copied to the host) at
        every ``every``-th step; returns the path or None."""
        if step % self.every != 0:
            return None
        path = save_checkpoint(self.directory, step,
                               tree_map(_host, dense_tree),
                               tree_map(_host, emb_tree)
                               if emb_tree is not None else None)
        self._gc()
        return path

    def maybe_save_state(self, step: int, trainer, state):
        """Full-state periodic save through PersiaTrainer.save: dense params
        + optimizer moments, every PS table with its adagrad accumulator
        (and a host_lru table's host tiers), and the staleness queues — so
        a restore resumes bit-identically."""
        if step % self.every != 0:
            return None
        path = trainer.save(self.directory, state, step=step)
        self._gc()
        return path

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
