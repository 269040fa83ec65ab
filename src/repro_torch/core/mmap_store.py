"""Disk/mmap embedding tier + the tiered host store that stacks it under
the host LRU: logical rows beyond host RAM (copy of
``repro/core/mmap_store.py``: numpy only, over the port's own ``lru``).

Two classes, both speaking the :class:`~repro_torch.core.lru.LRUEmbeddingStore`
bulk API (``read_rows`` / ``write_rows`` / ``preload`` / ``serialize``)
so the host_lru backend can swap either in without touching its fault
path:

* :class:`MmapEmbeddingStore` — the bottom tier. All ``rows`` logical
  rows of one table live in memory-mapped ``.npy`` files (vectors +
  adagrad accumulators + a liveness byte per row); the id IS the row
  index, so reads/writes are fancy-indexed memmap slices and the OS page
  cache decides what is actually resident. Never-written rows initialise
  on first read from a seeded RNG — the same per-row
  ``standard_normal(dim) * init_scale`` draw, in the same order, as the
  LRU store's miss path, so which tier serves a first touch never
  changes the value.
* :class:`TieredHostStore` — host LRU tier of ``host_rows`` rows over an
  MmapEmbeddingStore of all ``rows``. Reads promote disk rows into the
  host tier; host-tier LRU evictions *spill* to disk through the store's
  ``on_evict`` hook (an eviction is a demotion, never a loss). Selected
  via ``EmbeddingSpec.backend="host_lru+disk"``: the device cache then
  sits on top, making the full hierarchy device-HBM -> host-RAM -> disk,
  the shape Persia §4.2.2 runs at 100T parameters.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from repro_torch.core.lru import (LRUEmbeddingStore, STORE_DTYPES,
                                  bs_blocks, bs_compress_rows,
                                  bs_decompress_rows, rng_state_array,
                                  set_rng_state)


class MmapEmbeddingStore:
    """All ``rows`` logical rows of one table, memory-mapped on disk."""

    def __init__(self, rows: int, dim: int, seed: int = 0,
                 init_scale: float = 0.02, path: str | None = None,
                 store_dtype: str = "fp32"):
        assert rows > 0
        self.capacity = int(rows)
        self.dim = int(dim)
        self._rng = np.random.default_rng(seed)
        self._init_scale = float(init_scale)
        if store_dtype not in STORE_DTYPES:
            raise ValueError(
                f"unknown store_dtype {store_dtype!r}: one of {STORE_DTYPES}")
        self.store_dtype = store_dtype
        if path is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="mmap_emb_")
            path = self._tmp.name
        else:
            self._tmp = None
            os.makedirs(path, exist_ok=True)
        self.path = path
        mm = np.lib.format.open_memmap
        # 'blockscale16' maps the vector payload as fp16 + one fp32 scale
        # per <=128-wide block — cold on-disk rows at ~half the bytes
        if store_dtype == "blockscale16":
            self.vectors = mm(os.path.join(path, "vectors.npy"), mode="w+",
                              dtype=np.float16,
                              shape=(self.capacity, self.dim))
            self.vec_scale = mm(os.path.join(path, "vec_scale.npy"),
                                mode="w+", dtype=np.float32,
                                shape=(self.capacity, bs_blocks(self.dim)))
        else:
            self.vectors = mm(os.path.join(path, "vectors.npy"), mode="w+",
                              dtype=np.float32,
                              shape=(self.capacity, self.dim))
            self.vec_scale = None
        self.opt_acc = mm(os.path.join(path, "opt_acc.npy"), mode="w+",
                          dtype=np.float32, shape=(self.capacity,))
        self.live = mm(os.path.join(path, "live.npy"), mode="w+",
                       dtype=np.uint8, shape=(self.capacity,))
        self.size = 0                        # live rows

    def _check_ids(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.capacity):
            raise ValueError(
                f"mmap store ids must be in [0, {self.capacity}) — the "
                "disk tier is keyed by logical row index")
        return ids

    def _mark_live(self, ids: np.ndarray):
        fresh = ids[self.live[ids] == 0]
        if fresh.size:
            self.live[fresh] = 1
            self.size += int(np.unique(fresh).size)

    # -- store_dtype-aware payload access -----------------------------------

    def _get_rows(self, ids) -> np.ndarray:
        if self.vec_scale is None:
            return np.asarray(self.vectors[ids], np.float32)
        return bs_decompress_rows(np.asarray(self.vectors[ids]),
                                  np.asarray(self.vec_scale[ids]))

    def _set_rows(self, ids, vals):
        vals = np.asarray(vals, np.float32).reshape(-1, self.dim)
        if self.vec_scale is None:
            self.vectors[ids] = vals
        else:
            comp, scale = bs_compress_rows(vals)
            self.vectors[ids] = comp
            self.vec_scale[ids] = scale

    def payload_bytes(self) -> int:
        n = self.vectors.nbytes
        if self.vec_scale is not None:
            n += self.vec_scale.nbytes
        return int(n)

    # -- bulk API (LRUEmbeddingStore-compatible) ----------------------------

    def read_rows(self, ids) -> tuple[np.ndarray, np.ndarray]:
        """Batched fetch, initialising never-written rows from the seeded
        RNG (one ``standard_normal(dim)`` draw per fresh row, in request
        order — the LRU store's exact miss-path stream)."""
        ids = self._check_ids(ids)
        miss = ids[self.live[ids] == 0]
        if miss.size:
            _, first = np.unique(miss, return_index=True)
            for k in miss[np.sort(first)].tolist():
                self._set_rows(np.array([k]),
                               (self._rng.standard_normal(self.dim)
                                * self._init_scale)[None])
                self.opt_acc[k] = 0.0
            self._mark_live(miss)
        return (self._get_rows(ids),
                np.asarray(self.opt_acc[ids], np.float32))

    def write_rows(self, ids, vectors, opt_acc=None):
        ids = self._check_ids(ids)
        self._set_rows(ids, np.asarray(vectors, np.float32)
                       .reshape(len(ids), self.dim))
        if opt_acc is not None:
            self.opt_acc[ids] = np.asarray(opt_acc, np.float32).reshape(-1)
        self._mark_live(ids)

    def preload(self, ids, vectors, opt_acc=None):
        """Bulk-load an EMPTY store (the backend's init path)."""
        if self.size != 0:
            raise ValueError("preload requires an empty store")
        self.write_rows(ids, vectors, opt_acc)

    def disk_bytes(self) -> int:
        return int(self.payload_bytes() + self.opt_acc.nbytes
                   + self.live.nbytes)

    # -- (de)serialisation --------------------------------------------------

    def serialize(self) -> dict[str, np.ndarray]:
        """``vectors`` is always decompressed fp32 (portable across
        store_dtypes); a blockscale16 store adds its raw payload so a
        matching-dtype restore is bit-exact (see LRUEmbeddingStore)."""
        keys = np.nonzero(np.asarray(self.live))[0].astype(np.int64)
        blob = {
            "keys": keys,
            "vectors": self._get_rows(keys),
            "opt_acc": np.asarray(self.opt_acc[keys], np.float32),
            "meta": np.array([self.capacity, self.dim, self.size],
                             np.int64),
            # second slot records the store_dtype (absent/0 = fp32)
            "store_cfg": np.array([self._init_scale,
                                   float(self.vec_scale is not None)],
                                  np.float64),
            "rng_state": rng_state_array(self._rng),
        }
        if self.vec_scale is not None:
            blob["vec16"] = np.asarray(self.vectors[keys])
            blob["vec16_scale"] = np.asarray(self.vec_scale[keys])
        return blob

    @classmethod
    def deserialize(cls, blob, path: str | None = None,
                    store_dtype: str | None = None
                    ) -> "MmapEmbeddingStore":
        rows, dim, _ = (int(x) for x in
                        np.asarray(blob["meta"]).reshape(-1)[:3])
        cfg = np.asarray(blob["store_cfg"], np.float64).reshape(-1)
        blob_bs = cfg.size > 1 and cfg[1] != 0.0
        target = store_dtype or ("blockscale16" if blob_bs else "fp32")
        store = cls(rows, dim, init_scale=float(cfg[0]), path=path,
                    store_dtype=target)
        set_rng_state(store._rng, blob["rng_state"])
        keys = np.asarray(blob["keys"], np.int64)
        if store.vec_scale is not None and blob_bs and "vec16" in blob:
            store.vectors[keys] = np.asarray(blob["vec16"])  # bit-exact
            store.vec_scale[keys] = np.asarray(blob["vec16_scale"])
            store.opt_acc[keys] = np.asarray(blob["opt_acc"], np.float32)
            store._mark_live(keys)
        else:
            store.write_rows(keys,
                             np.asarray(blob["vectors"], np.float32),
                             np.asarray(blob["opt_acc"], np.float32))
        return store


class TieredHostStore:
    """Host LRU tier (``host_rows``, evicting) over a disk tier holding
    all ``rows`` — the lower two levels of the three-tier hierarchy.

    Reads resolve hits from the host tier, promote misses disk -> host
    (which may demote the host tier's LRU tail back to disk via
    ``on_evict``), and always return the freshest copy. The backend's
    fault path and serve-path ``read_rows`` use this unchanged — they
    only ever see the LRU bulk API.
    """

    def __init__(self, rows: int, dim: int, host_rows: int,
                 seed: int = 0, init_scale: float = 0.02,
                 path: str | None = None, store_dtype: str = "fp32"):
        if host_rows < 1:
            raise ValueError(f"host_rows must be >= 1 (got {host_rows})")
        self.capacity = int(rows)            # logical rows (disk tier)
        self.dim = int(dim)
        self.store_dtype = store_dtype
        # the host tier genuinely evicts, so it MUST track recency —
        # unlike the backend's plain all-rows store, which never does
        self.host = LRUEmbeddingStore(min(int(host_rows), int(rows)), dim,
                                      seed=seed, init_scale=init_scale,
                                      track_recency=True,
                                      store_dtype=store_dtype)
        self.disk = MmapEmbeddingStore(rows, dim, seed=seed,
                                       init_scale=init_scale, path=path,
                                       store_dtype=store_dtype)
        self.host.on_evict = self._spill
        self.promotions = 0                  # rows moved disk -> host
        self.spills = 0                      # rows demoted host -> disk

    def _spill(self, key: int, vec: np.ndarray, acc: np.ndarray):
        self.disk.write_rows(np.array([key], np.int64),
                             vec[None, :], np.array([acc], np.float32))
        self.spills += 1

    @property
    def size(self) -> int:
        """Distinct live logical rows across both tiers."""
        keys = self.host.keys[: self.host.size]
        keys = keys[keys >= 0]
        extra = int(np.count_nonzero(
            np.asarray(self.disk.live)[keys] == 0))
        return self.disk.size + extra

    @property
    def evictions(self) -> int:
        return self.host.evictions

    def recency_ids(self) -> list[int]:
        """Host-tier ids most- to least-recently used."""
        return self.host.recency_ids()

    # -- bulk API ------------------------------------------------------------

    def read_rows(self, ids) -> tuple[np.ndarray, np.ndarray]:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and np.unique(ids).size > self.host.capacity:
            raise ValueError(
                f"batch of {np.unique(ids).size} unique rows exceeds the "
                f"host tier ({self.host.capacity} rows) — raise "
                "EmbeddingSpec.host_rows or shrink the batch")
        _, slots = self.host._resolve(ids)
        hit = slots >= 0
        out_v = np.empty((len(ids), self.dim), np.float32)
        out_a = np.empty(len(ids), np.float32)
        if hit.any():
            # read (and MRU-touch) hits BEFORE promoting misses, so a
            # promotion-driven eviction can never demote a row this very
            # batch still needs un-read
            out_v[hit], out_a[hit] = self.host.read_rows(ids[hit])
        missing = ids[~hit]
        if missing.size:
            _, first = np.unique(missing, return_index=True)
            m = missing[np.sort(first)]
            d_v, d_a = self.disk.read_rows(m)
            self.host.write_rows(m, d_v, d_a)     # promote; tail spills
            self.promotions += int(m.size)
            order = np.argsort(m, kind="stable")
            sel = order[np.searchsorted(m[order], missing)]
            out_v[~hit] = d_v[sel]
            out_a[~hit] = d_a[sel]
        return out_v, out_a

    def write_rows(self, ids, vectors, opt_acc=None):
        """Writes land in the host tier (the freshest copy); host-tier
        allocations spill the LRU tail to disk as needed."""
        self.host.write_rows(ids, vectors, opt_acc)

    def preload(self, ids, vectors, opt_acc=None):
        """Bulk-load an EMPTY hierarchy: everything lands on disk, the
        host tier starts cold and fills by promotion."""
        if self.host.size != 0 or self.disk.size != 0:
            raise ValueError("preload requires an empty store")
        self.disk.preload(ids, vectors, opt_acc)

    def host_bytes(self) -> int:
        h = self.host
        return int(h.payload_bytes() + h.opt_acc.nbytes + h.prev.nbytes
                   + h.next.nbytes + h.keys.nbytes)

    def payload_bytes(self) -> int:
        """Vector payload bytes across both resident tiers."""
        return int(self.host.payload_bytes() + self.disk.payload_bytes())

    def disk_bytes(self) -> int:
        return self.disk.disk_bytes()

    # -- (de)serialisation --------------------------------------------------

    def serialize(self) -> dict:
        """Three-tier checkpoint sub-blob. ``meta`` keeps the LRU store's
        ``[capacity(=rows), dim, ...]`` head so the backend's restore
        validation reads either format the same way; the ``disk`` key is
        what distinguishes a tiered blob from a plain two-tier one."""
        return {
            "meta": np.array([self.capacity, self.dim, 0, 0, self.size,
                              self.host.evictions], np.int64),
            "tier_meta": np.array([self.host.capacity, self.promotions,
                                   self.spills], np.int64),
            "host": self.host.serialize(),
            "disk": self.disk.serialize(),
        }

    @classmethod
    def deserialize(cls, blob, path: str | None = None,
                    store_dtype: str | None = None) -> "TieredHostStore":
        rows, dim = (int(x) for x in
                     np.asarray(blob["meta"]).reshape(-1)[:2])
        tm = [int(x) for x in np.asarray(blob["tier_meta"]).reshape(-1)]
        store = cls(rows, dim, host_rows=tm[0], path=path,
                    store_dtype=store_dtype or "fp32")
        store.host = LRUEmbeddingStore.deserialize(blob["host"],
                                                   store_dtype=store_dtype)
        store.host.on_evict = store._spill
        store.disk = MmapEmbeddingStore.deserialize(blob["disk"], path=path,
                                                    store_dtype=store_dtype)
        store.store_dtype = store.host.store_dtype
        store.promotions, store.spills = tm[1], tm[2]
        return store
