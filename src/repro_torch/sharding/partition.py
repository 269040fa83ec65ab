"""Partition rules for every tree the launcher places on a mesh (port of
``repro/sharding/partition.py``).

Scheme: Megatron-style tensor parallelism over ``model`` x FSDP over
``data`` for the dense backbone; embedding PS tables row-sharded per their
EmbeddingSpec mode; expert stacks over ``model`` (expert parallelism);
decode caches sequence-sharded over ``model``; batch over (pod, data).
Multi-pod: weights are replicated across pods, while the batch also shards
over ``pod``.

The rules are the JAX package's, spec for spec, on the port's trees (the
same key paths). A spec is :class:`P`, a tuple of one entry per tensor dim
(None, an axis name or a tuple of names). Where the JAX package hands the
specs to XLA (``to_shardings``), the port's SPMD code places blocks itself:
:func:`to_placements` gives each leaf's DTensor placements (one ``Shard``
or ``Replicate`` per mesh dim), :func:`local_block` cuts a global tensor
into a rank's block (what a ``shard_map`` body sees under ``in_specs``)
and :func:`from_blocks` joins every rank's blocks back (``out_specs``).
"""
from __future__ import annotations

import contextlib
import os
import re
from typing import Any

import torch

from repro_torch.core.embedding_ps import EmbeddingSpec, table_spec

BATCH = ("pod", "data")


class P(tuple):
    """A partition spec, ``jax.sharding.PartitionSpec``'s counterpart: one
    entry per leading tensor dim (None, an axis name or a tuple of names;
    a one-name tuple is the name), later dims replicated."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return "P" + tuple.__repr__(self)


# ZeRO stage for the dense stack:
#   3 (default) — params sharded ('data', 'model'): every layer all-gathers
#       its weights over 'data' in fwd + bwd (+ remat)
#   2 — params replicated over 'data' (still TP over 'model'); optimizer
#       m/v stay 'data'-sharded
ZERO_STAGE = int(os.environ.get("REPRO_ZERO_STAGE", "3"))


@contextlib.contextmanager
def zero_stage(stage: int):
    """``ZERO_STAGE`` set to ``stage`` while open, for a run in the same
    process (``REPRO_ZERO_STAGE`` sets it for a process)."""
    global ZERO_STAGE
    prev, ZERO_STAGE = ZERO_STAGE, int(stage)
    try:
        yield
    finally:
        ZERO_STAGE = prev

# param-name -> (spec for 2D (d_in, d_out)) rules
_COL_PARALLEL = {"wq", "wk", "wv", "wg", "wu", "wuq", "wuk", "wuv", "wq_b",
                 "lm_head"}
_ROW_PARALLEL = {"wo", "wd", "out_proj"}
_FSDP_ONLY = {"in_proj", "wdq", "wdkv", "w"}          # mixed/ragged out dims
_REPLICATED = {"router", "conv_w", "b"}


def _key_str(k) -> str:
    """One key of a tree path as ``jax.tree_util.keystr`` writes it."""
    return f"[{k}]" if isinstance(k, int) else f"[{k!r}]"


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over nested dicts/lists/tuples (``None`` stays),
    with JAX's key-path strings (``"['stack']['wq']"``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + _key_str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_with_path(fn, v, path + _key_str(i))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _dense_leaf_spec(path: str, leaf, stage=None) -> P:
    stage = ZERO_STAGE if stage is None else stage
    name = re.findall(r"\['([^']+)'\]", path)[-1]
    in_stack = "['stack']" in path
    nd = leaf.ndim

    def wrap(*spec):
        # stacked (scan) params carry a leading repeats dim
        return P(None, *spec) if in_stack else P(*spec)

    base_nd = nd - 1 if in_stack else nd
    # MoE expert stacks: (E, d_in, d_out) -> experts over model (expert
    # parallelism) x FSDP over data on d_in
    if base_nd == 3 and name in ("wg", "wu", "wd"):
        return wrap("model", "data" if stage >= 3 else None, None)
    if base_nd == 2:
        fsdp = "data" if stage >= 3 else None
        if name in _COL_PARALLEL:
            return wrap(fsdp, "model")
        if name in _ROW_PARALLEL:
            return wrap("model", fsdp)
        if name in _FSDP_ONLY:
            return wrap("data", None)
        if name in ("pos_emb", "dec_pos_emb", "in_proj"):
            return wrap("data", None)
        return wrap(None, None)
    return wrap(*([None] * base_nd))


def dense_param_specs(params, stage=None) -> Any:
    return _map_with_path(lambda p, x: _dense_leaf_spec(p, x, stage), params)


def emb_state_specs(emb_state, spec: EmbeddingSpec):
    """Dense PS shards row-shard per their mode; a host_lru device cache
    (table + acc + slot_ids over cache_rows slots) row-shards the same
    way. A sharded router's state ({"s0": sub_state, ...}) gets one spec
    tree per PS shard."""
    if "table" not in emb_state:         # sharded router: per-shard states
        return {k: emb_state_specs(v, spec) for k, v in emb_state.items()}
    t = table_spec(spec)
    out = {"table": t}
    if "acc" in emb_state:
        out["acc"] = P(t[0])
    if "slot_ids" in emb_state:
        out["slot_ids"] = P(t[0])
    return out


def queue_specs(queue):
    """Staleness-queue specs: (tau, W[, dim]) arrays shard their width over
    the batch axes (W is the unique-width dedup cap, a multiple of
    min(1024, occurrences), so it divides over up to 1024 batch shards;
    ``_guard`` drops the axis where it does not). ``ptr`` and ``filled``
    are host ints in the port: their spec is ``P()``, as in JAX."""
    if queue is None:
        return None
    if "ids" not in queue:               # sharded router: per-shard queues
        return {k: queue_specs(v) for k, v in queue.items()}
    out = {"ids": P(None, BATCH), "grads": P(None, BATCH, None),
           "ptr": P(), "filled": P()}
    if "slots" in queue:                 # host_lru queues carry (slot, id)
        out["slots"] = P(None, BATCH)
    return out


def _dense_queue_specs(dense_queue, dense):
    if dense_queue is None:
        return None
    return {"grads": _map_with_path(lambda _, s: P(None, *s), dense,),
            "ptr": P(), "filled": P()}


def state_specs(state, emb_spec: EmbeddingSpec):
    """Spec tree for the legacy (dict, single-table) hybrid train state."""
    dense = dense_param_specs(state["dense"])
    return {
        "dense": dense,
        "opt": _opt_specs(state["opt"], dense),
        "emb": emb_state_specs(state["emb"], emb_spec),
        "emb_queue": queue_specs(state["emb_queue"]),
        "dense_queue": _dense_queue_specs(state["dense_queue"], dense),
        "step": P(),
    }


def collection_state_specs(emb_states, collection):
    """Per-table PS-state specs for an EmbeddingCollection's state dict."""
    return {n: emb_state_specs(emb_states[n], collection[n])
            for n in emb_states}


def collection_queue_specs(queues):
    return {n: queue_specs(q) for n, q in queues.items()}


def train_state_specs(state, collection):
    """Spec tree for a PersiaTrainer TrainState (mirrors its fields)."""
    from repro_torch.core.hybrid import TrainState
    dense = dense_param_specs(state.dense)
    return TrainState(
        dense=dense,
        opt=_opt_specs(state.opt, dense),
        emb=collection_state_specs(state.emb, collection),
        emb_queue=collection_queue_specs(state.emb_queue),
        dense_queue=_dense_queue_specs(state.dense_queue, dense),
        step=P(),
    )


def _opt_specs(opt_state, dense_specs):
    out = {}
    for k, v in opt_state.items():
        if k in ("m", "v"):
            # optimizer moments always ZeRO-sharded over 'data' (stage >= 2)
            out[k] = _map_with_path(lambda p, x: _dense_leaf_spec(p, x, 3),
                                    v)
        else:
            out[k] = P()
    return out


def batch_specs(batch) -> Any:
    return _map_with_path(lambda _, x: P(BATCH, *([None] * (x.ndim - 1))),
                          batch)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def _cache_leaf_spec(path: str, leaf, cfg) -> P:
    name = re.findall(r"\['([^']+)'\]", path)[-1]
    in_stack = "['stack']" in path
    nd = leaf.ndim

    def wrap(*spec):
        return P(None, *spec) if in_stack else P(*spec)

    base_nd = nd - 1 if in_stack else nd
    if name == "pos":
        return P(BATCH)
    if name in ("len", "filled", "ptr"):
        return wrap(BATCH) if base_nd else wrap()
    if name in ("k", "v"):
        # (B, S_or_ring_or_M, Hkv, Dh): shard seq over model when full-length
        S = leaf.shape[-3]
        seq_shardable = (cfg.sliding_window <= 0 or S > cfg.sliding_window) \
            and S % 16 == 0
        # ring buffers & short memories stay replicated over model
        if "cross" in path:
            seq_shardable = S % 16 == 0
        if cfg.sliding_window > 0 and S <= max(cfg.sliding_window, 8192):
            seq_shardable = False
        return wrap(BATCH, "model" if seq_shardable else None, None, None)
    if name in ("ckv", "k_rope"):
        return wrap(BATCH, "model", None)
    if name == "h":                                   # SSM state (B,H,N,P)
        return wrap(BATCH, "model", None, None)
    if name == "conv":                                # (B, K-1, C)
        return wrap(BATCH, None, None)
    return wrap(*([None] * base_nd))


def cache_specs(caches, cfg) -> Any:
    return _map_with_path(lambda p, x: _cache_leaf_spec(p, x, cfg), caches)


# ---------------------------------------------------------------------------
# Specs on a mesh: placements, and a rank's block of a global tensor
# ---------------------------------------------------------------------------

def _axis_n(mesh, e) -> int:
    if e is None:
        return 1
    if isinstance(e, (tuple, list)):
        n = 1
        for a in e:
            n *= mesh.shape[a]
        return n
    return mesh.shape[e]


def _guard(spec: P, mesh, leaf) -> P:
    """Drop the axes of the dims they do not divide."""
    parts = list(spec) + [None] * (leaf.ndim - len(spec))
    for i, e in enumerate(parts):
        if e is not None and leaf.shape[i] % _axis_n(mesh, e) != 0:
            parts[i] = None
    return P(*parts)


def _strip(spec: P, mesh) -> P:
    """Drop axis names the mesh doesn't have (e.g. 'pod' on single-pod)."""
    names = set(mesh.axis_names)

    def fix(e):
        if e is None:
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(x for x in e if x in names)
            return kept if kept else None
        return e if e in names else None

    return P(*(fix(e) for e in spec))


def _fit(spec: P, mesh, leaf) -> P:
    return _guard(_strip(spec, mesh), mesh, leaf)


def to_placements(mesh, spec_tree, shape_tree):
    """Per leaf, the DTensor placements of its spec on ``mesh`` (unknown
    axes and axes that do not divide their dim dropped): a tuple with one
    ``Shard(dim)`` or ``Replicate()`` per mesh dim. A dim sharded over
    several axes is ``Shard(dim)`` on each of them (DTensor nests them in
    mesh order, JAX's order for a tuple of axes in mesh order)."""
    try:
        from torch.distributed.tensor.placement_types import (Replicate,
                                                              Shard)
    except ImportError:                 # torch releases before 2.4
        from torch.distributed._tensor.placement_types import (Replicate,
                                                               Shard)

    def one(spec, leaf):
        spec = _fit(spec, mesh, leaf)
        out = [Replicate()] * len(mesh.axis_names)
        for dim, e in enumerate(spec):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                out[mesh.axis_names.index(a)] = Shard(dim)
        return tuple(out)

    return _zip_map(one, spec_tree, shape_tree)


def _zip_map(fn, spec_tree, tree):
    """``fn(spec, leaf)`` over a spec tree and a tree of the same
    structure (``None`` stays)."""
    if isinstance(spec_tree, P):
        return fn(spec_tree, tree)
    if spec_tree is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: _zip_map(fn, v, tree[k]) for k, v in spec_tree.items()}
    return type(spec_tree)(_zip_map(fn, s, t)
                           for s, t in zip(spec_tree, tree))


def local_block(mesh, spec: P, x: torch.Tensor, rank: int | None = None
                ) -> torch.Tensor:
    """The block of the global ``x`` that ``rank`` (default: this rank of
    ``mesh``) holds under ``spec``: each dim cut into equal parts over its
    axes (in mesh order), the rank's part kept (a view)."""
    rank = mesh.rank if rank is None else rank
    spec = _fit(spec, mesh, x)
    for dim, e in enumerate(spec):
        if e is None:
            continue
        n = _axis_n(mesh, e)
        i = mesh.flat_index(e, rank)
        size = x.shape[dim] // n
        x = x.narrow(dim, i * size, size)
    return x


def from_blocks(mesh, spec: P, blocks: list, shape=None) -> torch.Tensor:
    """The global tensor from every rank's block (``blocks[r]``, rank
    order): the inverse of :func:`local_block`. ``shape``, the global
    shape, drops the axes that do not divide a dim, as ``local_block``
    drops them; a replicated dim takes the first rank's block."""
    like = blocks[0]
    full = _strip(spec, mesh) if shape is None else \
        _fit(spec, mesh, torch.empty(shape, device="meta"))
    parts = list(full) + [None] * (like.dim() - len(full))
    out = like.new_empty([s * _axis_n(mesh, e)
                          for s, e in zip(like.shape, parts)])
    for r, b in enumerate(blocks):
        view = out
        for dim, e in enumerate(parts):
            if e is not None:
                size = b.shape[dim]
                view = view.narrow(dim, mesh.flat_index(e, r) * size, size)
        view.copy_(b)
    return out
