"""Persia §4.2.2 memory management (copy of ``repro/core/lru.py``: numpy
only, the port imports nothing of ``repro``): the embedding-PS LRU cache,
implemented with an *array-list* + hash-map (faithful to the paper's
design — pointers are array indices, not memory addresses, so
(de)serialisation is a straight memory copy and there is no per-entry
allocation).

This is the host-side, out-of-core tier: on a real deployment the device
shard is the hot set and this store backs it in PS-node RAM. Here it backs
the capacity benchmark (Criteo-Syn scaling family) and checkpointing.
Each entry holds the embedding vector and its optimizer state (adagrad
accumulator), exactly as the paper stores both in the array item.
"""
from __future__ import annotations

import numpy as np

_NIL = -1
_U64_MASK = (1 << 64) - 1

# blockscale16 row codec — the wire format (kernels/ref.py) applied at
# rest: fp16 payload + one fp32 scale per <=128-wide block of the row
BS_KAPPA = 32_768.0
BS_BLOCK = 128
STORE_DTYPES = ("fp32", "blockscale16")


def bs_blocks(dim: int) -> int:
    return -(-int(dim) // BS_BLOCK)


def bs_compress_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n, dim) fp32 -> ((n, dim) fp16 payload, (n, ceil(dim/128)) fp32
    scales). Per-row blocks; the trailing partial block is padded with
    zeros for the linf only (payload keeps the true width)."""
    rows = np.asarray(rows, np.float32)
    n, dim = rows.shape
    nb = bs_blocks(dim)
    pad = nb * BS_BLOCK - dim
    buf = np.pad(rows, ((0, 0), (0, pad))) if pad else rows
    blk = buf.reshape(n, nb, BS_BLOCK)
    linf = np.max(np.abs(blk), axis=-1)
    scale = (BS_KAPPA / np.maximum(linf, 1e-30)).astype(np.float32)
    comp = (blk * scale[:, :, None]).astype(np.float16)
    return comp.reshape(n, nb * BS_BLOCK)[:, :dim], scale


def bs_decompress_rows(comp: np.ndarray, scale: np.ndarray) -> np.ndarray:
    n, dim = comp.shape
    nb = scale.shape[1]
    pad = nb * BS_BLOCK - dim
    buf = comp.astype(np.float32)
    if pad:
        buf = np.pad(buf, ((0, 0), (0, pad)))
    blk = buf.reshape(n, nb, BS_BLOCK) / scale[:, :, None]
    return blk.reshape(n, nb * BS_BLOCK)[:, :dim]


def rng_state_array(rng: np.random.Generator) -> np.ndarray:
    """PCG64 bit-generator state as 6 uint64 scalars (the two 128-bit
    ints split lo/hi) so a restored store's miss-path init continues the
    exact same random stream."""
    st = rng.bit_generator.state
    s = st["state"]
    return np.array([s["state"] & _U64_MASK,
                     (s["state"] >> 64) & _U64_MASK,
                     s["inc"] & _U64_MASK, (s["inc"] >> 64) & _U64_MASK,
                     int(st["has_uint32"]), int(st["uinteger"])],
                    np.uint64)


def set_rng_state(rng: np.random.Generator, arr: np.ndarray) -> None:
    a = [int(x) for x in np.asarray(arr, np.uint64).reshape(-1)]
    rng.bit_generator.state = {
        "bit_generator": "PCG64",
        "state": {"state": a[0] | (a[1] << 64),
                  "inc": a[2] | (a[3] << 64)},
        "has_uint32": a[4], "uinteger": a[5]}


class LRUEmbeddingStore:
    """Fixed-capacity LRU keyed by int64 id -> (vector, optimizer slot)."""

    def __init__(self, capacity: int, dim: int, seed: int = 0,
                 init_scale: float = 0.02, track_recency: bool = True,
                 store_dtype: str = "fp32"):
        assert capacity > 0
        self.capacity = capacity
        self.dim = dim
        self._rng = np.random.default_rng(seed)
        self._init_scale = init_scale
        # track_recency=False skips the per-access linked-list touch on the
        # batched read/write paths (allocation order still recorded). The
        # embedding backends run their stores this way: those stores hold
        # ALL logical rows and never evict, so per-access LRU upkeep is
        # pure (GIL-bound) overhead on the fault path — it was the
        # serializing cost that kept concurrent per-shard fault-ins from
        # scaling. Stores that actually evict must keep the default.
        self.track_recency = track_recency
        if store_dtype not in STORE_DTYPES:
            raise ValueError(
                f"unknown store_dtype {store_dtype!r}: one of {STORE_DTYPES}")
        self.store_dtype = store_dtype
        # array-list: vectors, optimizer state, prev/next indices, keys.
        # 'blockscale16' keeps the vector payload fp16 with one fp32 scale
        # per <=128-wide block; every read decompresses, every write
        # recompresses (cold rows cost ~half the bytes, the optimizer math
        # upstream stays fp32).
        if store_dtype == "blockscale16":
            self.vectors = np.zeros((capacity, dim), np.float16)
            self.vec_scale = np.zeros((capacity, bs_blocks(dim)), np.float32)
        else:
            self.vectors = np.zeros((capacity, dim), np.float32)
            self.vec_scale = None
        self.opt_acc = np.zeros((capacity,), np.float32)
        self.prev = np.full(capacity, _NIL, np.int64)
        self.next = np.full(capacity, _NIL, np.int64)
        self.keys = np.full(capacity, _NIL, np.int64)
        self.index: dict[int, int] = {}     # hash-map: id -> array slot
        self.head = _NIL                    # most-recently used
        self.tail = _NIL                    # least-recently used
        self.size = 0
        self.evictions = 0
        # optional spill hook: called as on_evict(key, vector, opt_acc)
        # with the row ABOUT to be overwritten — the tiered host store
        # (core/mmap_store.py) wires this to its disk tier so an eviction
        # is a demotion, not a loss. Not serialized; owners rewire it.
        self.on_evict = None

    # -- linked-list ops on array indices ------------------------------------
    def _unlink(self, slot: int):
        p, n = self.prev[slot], self.next[slot]
        if p != _NIL:
            self.next[p] = n
        else:
            self.head = n
        if n != _NIL:
            self.prev[n] = p
        else:
            self.tail = p
        self.prev[slot] = self.next[slot] = _NIL

    def _push_front(self, slot: int):
        self.prev[slot] = _NIL
        self.next[slot] = self.head
        if self.head != _NIL:
            self.prev[self.head] = slot
        self.head = slot
        if self.tail == _NIL:
            self.tail = slot

    def _touch(self, slot: int):
        if self.head == slot:
            return
        self._unlink(slot)
        self._push_front(slot)

    # -- store_dtype-aware payload access ------------------------------------
    def _get_rows(self, slots) -> np.ndarray:
        """Decompressed fp32 vector rows for array-indexable ``slots``."""
        if self.vec_scale is None:
            return np.asarray(self.vectors[slots], np.float32)
        return bs_decompress_rows(self.vectors[slots], self.vec_scale[slots])

    def _set_rows(self, slots, vals):
        vals = np.asarray(vals, np.float32).reshape(-1, self.dim)
        if self.vec_scale is None:
            self.vectors[slots] = vals
        else:
            comp, scale = bs_compress_rows(vals)
            self.vectors[slots] = comp
            self.vec_scale[slots] = scale

    def payload_bytes(self) -> int:
        """Bytes held by the vector payload (the store_dtype-scaled part)."""
        n = self.vectors.nbytes
        if self.vec_scale is not None:
            n += self.vec_scale.nbytes
        return int(n)

    def _alloc(self, key: int) -> int:
        if self.size < self.capacity:
            slot = self.size
            self.size += 1
        else:
            slot = self.tail                 # evict LRU
            self._unlink(slot)
            old = int(self.keys[slot])
            if self.on_evict is not None:
                self.on_evict(old, self._get_rows(np.array([slot]))[0],
                              self.opt_acc[slot])
            del self.index[old]
            self.evictions += 1
        self.keys[slot] = key
        self.index[key] = slot
        self._push_front(slot)
        return slot

    def _touch_many(self, slots: list[int]):
        """Touch slots in sequence (later = more recent). Equivalent to
        calling _touch per slot, but deduplicated to the last occurrence so
        the linked-list walk is one unlink+push per distinct slot."""
        seen = set()
        order = []
        for s in reversed(slots):
            if s not in seen:
                seen.add(s)
                order.append(s)
        for s in reversed(order):
            if self.head != s:
                self._unlink(s)
                self._push_front(s)

    def _resolve(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batched id -> slot resolution: (int64 ids, int64 slots, -1 miss)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        idx = self.index
        slots = np.fromiter((idx.get(k, -1) for k in ids.tolist()),
                            np.int64, len(ids))
        return ids, slots

    # -- public API -------------------------------------------------------------
    def get(self, ids: np.ndarray) -> np.ndarray:
        """Fetch rows (allocating/initialising on miss). ids: (n,) int64."""
        return self.read_rows(ids)[0]

    def read_rows(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batched fetch of (vectors, optimizer accumulators), allocating and
        initialising on miss. The hit path is numpy-batched: one dict sweep
        for slot resolution, one linked-list recency pass, one fancy-indexed
        gather per array. Batches containing misses walk per id — an
        allocation's eviction can invalidate a slot resolved earlier in the
        same batch, so only the all-hit case is safely batchable."""
        ids, slots = self._resolve(ids)
        if slots.size and (slots >= 0).all():
            if self.track_recency:
                self._touch_many(slots.tolist())
            return self._get_rows(slots), self.opt_acc[slots].copy()
        out_v = np.empty((len(ids), self.dim), np.float32)
        out_a = np.empty(len(ids), np.float32)
        for i, key in enumerate(ids.tolist()):
            slot = self.index.get(key)
            if slot is None:
                slot = self._alloc(key)
                # write-then-read so a fresh row's first touch returns the
                # same (store_dtype round-tripped) value as later reads
                self._set_rows(np.array([slot]),
                               (self._rng.standard_normal(self.dim)
                                * self._init_scale)[None])
                self.opt_acc[slot] = 0.0
            elif self.track_recency:
                self._touch(slot)
            out_v[i] = self._get_rows(np.array([slot]))[0]
            out_a[i] = self.opt_acc[slot]
        return out_v, out_a

    def put(self, ids: np.ndarray, grads: np.ndarray, lr: float = 1e-2,
            eps: float = 1e-8):
        """Apply gradient rows with the PS-side adagrad (lock-free analog:
        last-writer-wins per row, matching Alg.1's no-lock semantics).
        Unique-id batches take a fully numpy-batched path; batches with
        repeated ids fall back to the sequential per-row semantics."""
        ids, slots = self._resolve(ids)
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        live = slots >= 0                    # paper: dropped puts tolerated
        if not live.any():
            return
        l_ids, l_slots, l_g = ids[live], slots[live], grads[live]
        if len(np.unique(l_slots)) == len(l_slots):
            acc = self.opt_acc[l_slots] + np.mean(l_g * l_g, axis=-1)
            self.opt_acc[l_slots] = acc
            self._set_rows(l_slots, self._get_rows(l_slots)
                           - lr * l_g / np.sqrt(acc + eps)[:, None])
            return
        for slot, g in zip(l_slots.tolist(), l_g):
            acc = self.opt_acc[slot] + float(np.mean(g * g))
            self.opt_acc[slot] = acc
            sl = np.array([slot])
            self._set_rows(sl, self._get_rows(sl)[0]
                           - lr * g / np.sqrt(acc + eps))

    def write_rows(self, ids: np.ndarray, vectors: np.ndarray,
                   opt_acc: np.ndarray | None = None):
        """Overwrite rows wholesale (the device cache's write-back path: the
        optimizer already ran on device, so values land verbatim). Allocates
        missing ids; batch-vectorized on the hit path; touches recency."""
        ids, slots = self._resolve(ids)
        vectors = np.asarray(vectors, np.float32).reshape(len(ids), self.dim)
        acc = None if opt_acc is None \
            else np.asarray(opt_acc, np.float32).reshape(-1)
        if slots.size and (slots >= 0).all():    # all-hit: fully batched
            self._set_rows(slots, vectors)
            if acc is not None:
                self.opt_acc[slots] = acc
            if self.track_recency:
                self._touch_many(slots.tolist())
            return
        for i, key in enumerate(ids.tolist()):   # misses: sequential allocs
            slot = self.index.get(key)
            if slot is None:
                slot = self._alloc(key)
            elif self.track_recency:
                self._touch(slot)
            self._set_rows(np.array([slot]), vectors[i][None])
            if acc is not None:
                self.opt_acc[slot] = acc[i]

    def preload(self, ids: np.ndarray, vectors: np.ndarray,
                opt_acc: np.ndarray | None = None):
        """Bulk-load an EMPTY store (the out-of-core backend's init path):
        rows land in slots 0..n-1 with recency = insertion order (last id
        most-recent), all linked-list pointers built vectorized."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        n = len(ids)
        if n == 0:
            return
        if self.size != 0:
            raise ValueError("preload requires an empty store")
        if n > self.capacity:
            raise ValueError(f"preload of {n} rows exceeds capacity "
                             f"{self.capacity}")
        self._set_rows(np.arange(n), np.asarray(vectors, np.float32)
                       .reshape(n, self.dim))
        if opt_acc is not None:
            self.opt_acc[:n] = np.asarray(opt_acc, np.float32).reshape(-1)
        self.keys[:n] = ids
        # chain: slot n-1 (inserted last) is MRU head, slot 0 is LRU tail
        self.prev[:n] = np.arange(1, n + 1, dtype=np.int64)
        self.prev[n - 1] = _NIL
        self.next[:n] = np.arange(-1, n - 1, dtype=np.int64)
        self.index = {int(k): i for i, k in enumerate(ids.tolist())}
        self.head, self.tail, self.size = n - 1, 0, n

    def recency_ids(self) -> list[int]:
        """Resident ids most- to least-recently used (test/inspection aid)."""
        out = []
        slot = self.head
        while slot != _NIL:
            out.append(int(self.keys[slot]))
            slot = int(self.next[slot])
        return out

    # -- zero-copy style (de)serialisation ---------------------------------------
    def _rng_state_array(self) -> np.ndarray:
        return rng_state_array(self._rng)

    def _set_rng_state(self, arr: np.ndarray):
        set_rng_state(self._rng, arr)

    def serialize(self) -> dict[str, np.ndarray]:
        """Pure-array snapshot — a memory copy, no pointer chasing.

        ``vectors`` is ALWAYS the decompressed fp32 rows (the portable
        logical payload any store_dtype — and any cross-format reader —
        can restore from); a blockscale16 store additionally snapshots its
        raw fp16 payload + scales so a matching-dtype restore is
        bit-exact (re-compressing a decompressed row can differ by one
        fp16 ulp when the block max re-rounds)."""
        blob = {
            "vectors": self._get_rows(np.arange(self.size)),
            "opt_acc": self.opt_acc[: self.size].copy(),
            "prev": self.prev[: self.size].copy(),
            "next": self.next[: self.size].copy(),
            "keys": self.keys[: self.size].copy(),
            "meta": np.array([self.capacity, self.dim, self.head, self.tail,
                              self.size, self.evictions], np.int64),
            # constructor/derived state the 6-scalar meta never carried:
            # a restored store that still faults/evicts must continue the
            # run bit-identically (same init stream, same recency upkeep);
            # the third slot records the store_dtype (absent = fp32)
            "store_cfg": np.array([self._init_scale,
                                   float(self.track_recency),
                                   float(self.vec_scale is not None)],
                                  np.float64),
            "rng_state": self._rng_state_array(),
        }
        if self.vec_scale is not None:
            blob["vec16"] = self.vectors[: self.size].copy()
            blob["vec16_scale"] = self.vec_scale[: self.size].copy()
        return blob

    @classmethod
    def deserialize(cls, blob: dict[str, np.ndarray],
                    store_dtype: str | None = None) -> "LRUEmbeddingStore":
        """``store_dtype=None`` rebuilds in the blob's recorded format;
        passing 'fp32' / 'blockscale16' restores into that format instead
        (cross-format: the decompressed fp32 ``vectors`` are re-encoded)."""
        cap, dim, head, tail, size, ev = \
            (int(x) for x in np.asarray(blob["meta"]).reshape(-1)[:6])
        cfg = blob.get("store_cfg")
        blob_bs = False
        if cfg is not None:                   # old blobs: 6-scalar meta only
            cfg = np.asarray(cfg, np.float64).reshape(-1)
            blob_bs = cfg.size > 2 and cfg[2] != 0.0
            target = store_dtype or ("blockscale16" if blob_bs else "fp32")
            store = cls(cap, dim, init_scale=float(cfg[0]),
                        track_recency=bool(cfg[1] != 0.0),
                        store_dtype=target)
        else:
            store = cls(cap, dim, store_dtype=store_dtype or "fp32")
        if "rng_state" in blob:
            store._set_rng_state(blob["rng_state"])
        if store.vec_scale is not None and blob_bs and "vec16" in blob:
            store.vectors[:size] = blob["vec16"]        # bit-exact payload
            store.vec_scale[:size] = blob["vec16_scale"]
        else:
            store._set_rows(np.arange(size),
                            np.asarray(blob["vectors"], np.float32))
        store.opt_acc[:size] = blob["opt_acc"]
        store.prev[:size] = blob["prev"]
        store.next[:size] = blob["next"]
        store.keys[:size] = blob["keys"]
        store.head, store.tail, store.size, store.evictions = head, tail, size, ev
        store.index = {int(k): i for i, k in enumerate(blob["keys"])}
        return store
