"""The port's sharded embedding-PS router (repro_torch ShardedBackend) on
the CPU: the ports of ``tests/test_sharded.py`` (same names and sizes: 2
fields x 64 rows x dim 8) and comparisons against the JAX package's router.

Tolerance classes:
* bit-exact: k shards against one shard (dense and host_lru, every mode,
  ``step`` and ``decomposed_step``), resharding restores (every logical
  row), same-geometry restores, the routing against the JAX package's,
  checkpoints JAX -> port -> JAX (every leaf), the pipelined trainer at
  max_inflight 1 against the serial one;
* allclose, the FFNN's class (``tests/test_torch_train.py``): the port's
  4-shard trainer against JAX's from one JAX-exported state — losses rtol
  1e-5; after 4 steps tables, dense params and queued grads rtol 1e-5 atol
  1e-6, accumulators rtol 1e-5 atol 1e-9, Adam's moments as
  ``_check_states``; queue ids, ring pointers, slot maps and counters
  exactly.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import \
    checkpoint_shard_layout as jcheckpoint_shard_layout
from repro.configs.base import ModelConfig as JConfig
from repro.core import adapters as jadapters
from repro.core import backend as jbackend
from repro.core import hybrid as jhybrid
from repro.data import ctr as jctr
from repro.optim import optimizers as jopt

from repro_torch import convert
from repro_torch.checkpoint import checkpoint_shard_layout
from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapters
from repro_torch.core import backend as BK
from repro_torch.core.backend import (CompressedWireBackend, DenseBackend,
                                      HostLRUBackend, ShardedBackend,
                                      create_backend)
from repro_torch.core.collection import EmbeddingCollection
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.core.pipeline import PipelinedTrainer
from repro_torch.data.ctr import CTRDataset
from repro_torch.optim.optimizers import OptConfig
from repro_torch.utils import tree_leaves

from test_torch_train import _close, _to_np

F, RPF, D = 2, 64, 8       # fields x rows-per-field x dim

CFG = ModelConfig(name="sh", arch_type="recsys", n_id_fields=F,
                  ids_per_field=3, emb_dim=D, emb_rows=F * RPF,
                  n_dense_features=4, mlp_dims=(16,), n_tasks=1)
DS = CTRDataset("sh", n_rows=F * RPF, n_fields=F, ids_per_field=3, n_dense=4)


def _batches(n, batch=16, seed=None):
    it = DS.sampler(batch, seed=seed)
    return [next(it) for _ in range(n)]


def _trainer(backend="dense", cache_rows=None, shards=1, tau=2, mode=None,
             batch_dedup=None):
    coll = adapters.ctr_collection(CFG, lr=5e-2, field_rows=DS.field_rows())
    if backend != "dense":
        coll = coll.with_backend(backend, cache_rows)
    if shards != 1:
        coll = coll.with_shards(shards)
    ad = adapters.recsys_adapter(CFG, field_rows=DS.field_rows(),
                                 collection=coll)
    return PersiaTrainer(ad, mode or TrainMode.hybrid(tau),
                         OptConfig(kind="adam", lr=5e-3),
                         batch_dedup=batch_dedup, device="cpu")


def _probe_all_rows(trainer, state, chunk=8):
    """Logical full-table view through each backend's own prepare and
    lookup, in chunks small (per-shard) caches can stream."""
    out = {}
    for n in trainer.collection.names:
        bk = trainer.backends[n]
        rows = []
        for lo in range(0, RPF, chunk):
            ids = torch.arange(lo, min(lo + chunk, RPF), dtype=torch.int32)
            st, dev = bk.prepare(state.emb[n], ids)
            state.emb = {**state.emb, n: st}
            acts, _ = bk.lookup(st, dev)
            rows.append(acts.numpy())
        out[n] = np.concatenate(rows)
    return out


# ---------------------------------------------------------------------------
# factory: shards=1 stays the plain backend, checkpoint bytes unchanged
# ---------------------------------------------------------------------------

def test_factory_shards1_is_plain_and_router_composes():
    spec = EmbeddingSpec(rows=64, dim=4, mode="full")
    assert isinstance(create_backend(spec), DenseBackend)
    assert isinstance(create_backend(
        dataclasses.replace(spec, emb_shards=4)), ShardedBackend)
    h = create_backend(dataclasses.replace(spec, backend="host_lru",
                                           cache_rows=16, emb_shards=2))
    assert isinstance(h, ShardedBackend)
    assert all(isinstance(s, HostLRUBackend) for s in h.shard_backends)
    # the wire wraps OUTSIDE the router (one wire per table)
    w = create_backend(dataclasses.replace(spec, backend="dense+compressed",
                                           emb_shards=2))
    assert isinstance(w, CompressedWireBackend)
    assert isinstance(w.inner, ShardedBackend)
    with pytest.raises(ValueError, match="shards"):
        ShardedBackend(spec, n_shards=1)
    with pytest.raises(ValueError, match="emb_shards"):
        EmbeddingCollection.single(
            "t", dataclasses.replace(spec, emb_shards=0))


def test_shards1_dense_checkpoint_bytes_unchanged(tmp_path):
    """emb_shards=1 keeps the plain dense path, down to the bytes a
    checkpoint writes (the on-disk format is the compat surface)."""
    b = _batches(1)[0]
    ta = _trainer("dense")            # spec default emb_shards=1
    pa = ta.save(str(tmp_path / "a"), ta.init(0, b))
    tb = _trainer("dense")
    pb = tb.save(str(tmp_path / "b"), tb.init(0, b))
    raw_a = open(f"{pa}/emb/data.bin", "rb").read()
    raw_b = open(f"{pb}/emb/data.bin", "rb").read()
    assert raw_a == raw_b and len(raw_a) > 0


# ---------------------------------------------------------------------------
# bit parity: k shards == 1 shard, dense and host_lru, every mode
# ---------------------------------------------------------------------------

MODES = {"sync": TrainMode.sync(), "hybrid": TrainMode.hybrid(2),
         "async": TrainMode.async_(2, 2)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("backend,cache", [("dense", None),
                                           ("host_lru", RPF),
                                           ("host_lru", 48),
                                           ("dense+compressed", None)],
                         ids=["dense", "host_lru", "host_lru_evicts",
                              "dense+compressed"])
def test_sharded_bit_parity_with_single_shard(backend, cache, mode):
    """4-shard router == plain backend bit for bit: per-step losses, every
    logical table row and eval, through ``decomposed_step`` and ``step``
    (the routing is a bijection and every row lives in one shard; the
    router's lookup gathers into one block without arithmetic and its put
    is the plain put decomposed into a sum-only and an apply-only launch,
    which compute the same fp32 operations)."""
    batches = _batches(6)
    t1 = _trainer(backend, cache, mode=MODES[mode])
    t4 = _trainer(backend, cache, shards=4, mode=MODES[mode])
    tf = _trainer(backend, cache, shards=4, mode=MODES[mode])
    s1, s4, sf = (t.init(0, batches[0]) for t in (t1, t4, tf))
    for b in batches:
        s1, m1 = t1.decomposed_step(s1, b)
        s4, m4 = t4.decomposed_step(s4, b)
        sf, _ = tf.step(sf, b)
        assert float(m1["loss"]) == float(m4["loss"])
    rows1, rows4 = _probe_all_rows(t1, s1), _probe_all_rows(t4, s4)
    rowsf = _probe_all_rows(tf, sf)
    for n in rows1:
        np.testing.assert_array_equal(rows1[n], rows4[n], err_msg=n)
        np.testing.assert_array_equal(rows1[n], rowsf[n], err_msg=n)
    assert float(t1.eval(s1, batches[0])["loss"]) == \
        float(t4.eval(s4, batches[0])["loss"])
    # the serve read: one block of the shards' unique rows, pooled
    np.testing.assert_array_equal(t1.predict(s1, batches[1]).numpy(),
                                  t4.predict(s4, batches[1]).numpy())


@pytest.mark.parametrize("mode", ["sync", "hybrid"])
@pytest.mark.parametrize("backend,cache", [("dense", None),
                                           ("host_lru", 48)],
                         ids=["dense", "host_lru_evicts"])
def test_sharded_occurrence_width_parity(backend, cache, mode):
    """``batch_dedup=False``: the router's occurrence-width lookup (each
    shard's rows selected where it owns the id) and its per-shard puts
    (grouped on the device) equal one shard's bit for bit. (Behind the
    wire the device grouping orders the put's rows by device id, which the
    router encodes by shard, and at dim 8 a codec block of 128 spans 16
    rows: the two round differently, in the JAX package too.)"""
    batches = _batches(5)
    t1, t4 = (_trainer(backend, cache, shards=k, mode=MODES[mode],
                       batch_dedup=False) for k in (1, 4))
    s1, s4 = t1.init(0, batches[0]), t4.init(0, batches[0])
    for b in batches:
        s1, m1 = t1.step(s1, b)
        s4, m4 = t4.step(s4, b)
        assert float(m1["loss"]) == float(m4["loss"])
    rows1, rows4 = _probe_all_rows(t1, s1), _probe_all_rows(t4, s4)
    for n in rows1:
        np.testing.assert_array_equal(rows1[n], rows4[n], err_msg=n)


def test_init_emb_shards_routes_host_backed_tables(tmp_path):
    """PersiaTrainer.init(emb_shards=k) routes host_lru tables through the
    router (the legacy dense meaning, padded rows, stays)."""
    batches = _batches(3)
    tr = _trainer("host_lru", RPF)                  # spec emb_shards=1
    state = tr.init(0, batches[0], emb_shards=2)
    for n in tr.collection.names:
        assert isinstance(tr.backends[n], ShardedBackend)
        assert tr.backends[n].n_shards == 2
    for b in batches:
        state, m = tr.decomposed_step(state, b)
    assert np.isfinite(float(m["loss"]))
    # parity with a spec-sharded trainer: same routing, same numbers
    t2 = _trainer("host_lru", RPF, shards=2)
    s2 = t2.init(0, batches[0])
    for b in batches:
        s2, m2 = t2.decomposed_step(s2, b)
    assert float(m["loss"]) == float(m2["loss"])
    # dense tables keep the legacy padding, through a save and restore
    td = _trainer("dense")
    sd = td.init(0, batches[0], emb_shards=3)
    assert isinstance(td.backends["field_00"], DenseBackend)
    assert sd.emb["field_00"]["table"].shape[0] == 66
    td.save(str(tmp_path), sd)
    rd = td.restore(str(tmp_path))
    assert torch.equal(rd.emb["field_00"]["table"], sd.emb["field_00"]["table"])


# ---------------------------------------------------------------------------
# resharding checkpoints: N-shard save -> M-shard restore, row-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,cache", [("dense", None),
                                           ("host_lru", RPF // 2)],
                         ids=["dense", "host_lru"])
def test_reshard_checkpoint_roundtrip_row_exact(backend, cache, tmp_path):
    """Save with N shards, restore with M, for N, M in {1, 2, 4}: every
    logical row (host store and device cache laid over it) comes back bit
    for bit, the shard layout reads off the disk, resharded queues restart
    empty, and training continues."""
    batches = _batches(3, batch=8)
    for N in (1, 2, 4):
        tN = _trainer(backend, cache, shards=N)
        s = tN.init(0, batches[0])
        for b in batches:
            s, _ = tN.decomposed_step(s, b)
        rows_src = _probe_all_rows(tN, s)
        d = str(tmp_path / f"{backend}_n{N}")
        tN.save(d, s)
        assert all(v == N for v in checkpoint_shard_layout(d).values())
        for M in (1, 2, 4):
            tM = _trainer(backend, cache, shards=M)
            r = tM.restore(d)
            assert int(r.step) == 3
            rows_dst = _probe_all_rows(tM, r)
            for n in rows_src:
                np.testing.assert_array_equal(rows_src[n], rows_dst[n],
                                              err_msg=f"N={N} M={M} {n}")
            if N != M:          # resharded: queues restart empty (warmup)
                for n in tM.collection.names:
                    q = r.emb_queue[n]
                    leaf = q["ids"] if "ids" in q else q["s0"]["ids"]
                    assert int(leaf.max()) == -1
                    assert BK.unwrap(tM.backends[n]).last_restore_resharded
            r, m = tM.decomposed_step(r, batches[0])
            assert np.isfinite(float(m["loss"]))


def test_same_geometry_sharded_restore_is_bit_identical(tmp_path):
    """N == M restore is the non-reshard path: identical continuation,
    the plain backend's bit-exact resume contract."""
    batches = _batches(6, batch=8)
    ta = _trainer("host_lru", RPF // 2, shards=2)
    s = ta.init(0, batches[0])
    for b in batches[:3]:
        s, _ = ta.decomposed_step(s, b)
    ta.save(str(tmp_path), s)
    for b in batches[3:]:
        s, _ = ta.decomposed_step(s, b)
    tb = _trainer("host_lru", RPF // 2, shards=2)
    r = tb.restore(str(tmp_path))
    for n in tb.collection.names:
        assert not BK.unwrap(tb.backends[n]).last_restore_resharded
    for b in batches[3:]:
        r, _ = tb.decomposed_step(r, b)
    rows_a, rows_b = _probe_all_rows(ta, s), _probe_all_rows(tb, r)
    for n in rows_a:
        np.testing.assert_array_equal(rows_a[n], rows_b[n], err_msg=n)


def test_reshard_rejects_cross_backend_and_row_mismatch(tmp_path):
    tr = _trainer("host_lru", RPF // 2, shards=2, tau=0)
    b = _batches(1, batch=8)[0]
    tr.save(str(tmp_path), tr.init(0, b))
    # a dense router cannot adopt a host_lru sharded checkpoint
    td = _trainer("dense", shards=4, tau=0)
    with pytest.raises(ValueError, match="backend"):
        td.restore(str(tmp_path))


# ---------------------------------------------------------------------------
# concurrency: two-thread prepare bijection under the per-shard locks
# ---------------------------------------------------------------------------

@pytest.mark.timeout(120)
def test_sharded_prepare_is_thread_safe():
    """Two threads hammering the router's concurrent prepare: every shard's
    slot bookkeeping stays an exact bijection, and the device ids decode
    into their shard's slot range."""
    spec = EmbeddingSpec(rows=512, dim=4, mode="full", optimizer="sgd",
                         backend="host_lru", cache_rows=192, emb_shards=4)
    bk = create_backend(spec)
    state0 = bk.init(torch.Generator().manual_seed(0))
    errors = []
    go = threading.Event()

    def hammer(seed):
        rng = np.random.default_rng(seed)
        go.wait()
        try:
            for _ in range(40):
                ids = rng.integers(0, spec.rows, 24)
                _, dev = bk.prepare(state0, ids)
                assert ((dev >= 0) & (dev < bk.dev_rows())).all()
        except Exception as e:   # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    for s, sub in enumerate(bk.shard_backends):
        assert len(set(sub._slot_for_id.values())) == len(sub._slot_for_id)
        for k, slot in sub._slot_for_id.items():
            assert int(sub._id_for_slot[slot]) == k, (s, k)
        occupied = {int(x) for x in np.nonzero(sub._id_for_slot >= 0)[0]}
        assert occupied == set(sub._slot_for_id.values())


# ---------------------------------------------------------------------------
# pipelined execution over a sharded table
# ---------------------------------------------------------------------------

@pytest.mark.timeout(240)
def test_pipelined_inflight1_bit_exact_over_sharded_host_lru():
    batches = _batches(12)
    ta = _trainer("host_lru", RPF, shards=2)
    sa, ms_a = ta.run(ta.init(0, batches[0]), batches)
    tb = _trainer("host_lru", RPF, shards=2)
    engine = PipelinedTrainer(tb, max_inflight=1)
    sb, ms_b = engine.run(tb.init(0, batches[0]), batches)
    assert [float(m["loss"]) for m in ms_a] == \
        [float(m["loss"]) for m in ms_b]
    for n in ta.collection.names:
        for s in sa.emb[n]:
            for k in sa.emb[n][s]:
                assert torch.equal(sa.emb[n][s][k], sb.emb[n][s][k]), (n, s)


@pytest.mark.timeout(240)
def test_deep_pipeline_pins_survive_sharded_eviction_pressure():
    """max_inflight > 1 over a sharded host_lru table with real eviction
    pressure: per-shard pins keep every in-flight batch's rows resident
    (no wrong-row reads, no dropped puts), order preserved."""
    batches = _batches(15, batch=4)
    tr = _trainer("host_lru", RPF // 2, shards=2, tau=2)
    engine = PipelinedTrainer(tr, max_inflight=3)
    state = engine.init(0, batches[0])
    state, ms = engine.run(state, batches)
    assert len(ms) == 15
    assert engine.applied_order == list(range(15))
    assert all(np.isfinite(float(m["loss"])) for m in ms)
    # a hybrid sharded table charges EVERY shard's window, so the per-table
    # outstanding-puts bound min(max_inflight, tau) holds
    for n, v in engine.max_outstanding.items():
        assert v <= min(3, 2), (n, v)
    faults = sum(int(s.faults) for n in tr.collection.names
                 for s in BK.unwrap(tr.backends[n]).shard_backends)
    assert faults > 0
    for n in tr.collection.names:
        for sub in BK.unwrap(tr.backends[n]).shard_backends:
            assert not sub._pin_count.any()


# ---------------------------------------------------------------------------
# hot-key skew: the load-imbalance gauge fires
# ---------------------------------------------------------------------------

def test_hot_key_skew_fires_imbalance_gauge():
    """90% of the id traffic on one key lands on one shard and pushes
    max/mean traffic well above 1: the gauge that makes hot-key skew
    visible in the step metrics."""
    tr = _trainer("host_lru", RPF, shards=4, tau=0)
    rng = np.random.default_rng(0)
    B, L = 16, 3

    def skewed_batch():
        ids = rng.integers(0, RPF, (B, F, L))
        hot = rng.random((B, F, L)) < 0.9
        return {"ids": np.where(hot, 7, ids).astype(np.int32),
                "dense": rng.standard_normal((B, 4)).astype(np.float32),
                "labels": (rng.random((B, 1)) < 0.3).astype(np.float32)}

    state = tr.init(0, skewed_batch())
    for _ in range(4):
        state, m = tr.decomposed_step(state, skewed_batch())
    gauges = {k: float(v) for k, v in m.items() if k.endswith("imbalance")}
    assert gauges and all(v > 2.0 for v in gauges.values()), gauges
    name = tr.collection.names[0]
    for s in range(4):
        for g in ("hit_rate", "faults", "rows", "bytes"):
            assert f"shard/{name}/{s}/{g}" in m
    # a balanced stream keeps the gauge near 1
    tb = _trainer("host_lru", RPF, shards=4, tau=0)
    bs = _batches(5, batch=16)
    sb = tb.init(0, bs[0])
    for b in bs:
        sb, mb = tb.decomposed_step(sb, b)
    assert all(float(v) < 2.0 for k, v in mb.items()
               if k.endswith("imbalance"))


# ---------------------------------------------------------------------------
# shard-mapping validation (mistyped table names fail loudly)
# ---------------------------------------------------------------------------

def test_shard_mapping_validates_table_names():
    coll = adapters.ctr_collection(CFG, lr=5e-2, field_rows=DS.field_rows())
    with pytest.raises(ValueError, match="unknown tables"):
        coll.with_shards({"field_typo": 4})
    with pytest.raises(ValueError, match="unknown tables"):
        coll.init(torch.Generator(), shards={"field_typo": 4})
    with pytest.raises(ValueError, match=">= 1"):
        coll.with_shards({"field_00": 0})
    tr = _trainer("host_lru", RPF)
    with pytest.raises(ValueError, match="unknown tables"):
        tr.init(0, _batches(1)[0], emb_shards={"field_typo": 2})
    # a valid mapping shards only the named table
    tr2 = _trainer("host_lru", RPF)
    tr2.init(0, _batches(1)[0], emb_shards={"field_00": 2})
    assert isinstance(tr2.backends["field_00"], ShardedBackend)
    assert isinstance(tr2.backends["field_01"], HostLRUBackend)


# ---------------------------------------------------------------------------
# against the JAX package's router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,k", [(64, 2), (64, 4), (1, 2), (1000, 3),
                                    (62_500, 4), (65_536, 4), (15_625, 7)])
def test_routing_equals_jax(rows, k):
    ids = np.arange(rows)
    got = BK._ShardRouting(rows, k)
    want = jbackend._ShardRouting(rows, k)
    assert (got.P, got.mult, got.add, got.sub_rows) == \
        (want.P, want.mult, want.add, want.sub_rows)
    for a, b in zip(got.shard_and_local(ids), want.shard_and_local(ids)):
        np.testing.assert_array_equal(a, b)


def _pair(mode, backend="dense", cache=None, shards=4):
    """A JAX and a port trainer over one k-shard collection."""
    jm = {"sync": jhybrid.TrainMode.sync(),
          "hybrid": jhybrid.TrainMode.hybrid(3),
          "async": jhybrid.TrainMode.async_(2, 2)}[mode]
    tm = {"sync": TrainMode.sync(), "hybrid": TrainMode.hybrid(3),
          "async": TrainMode.async_(2, 2)}[mode]
    jcfg = JConfig(**dataclasses.asdict(CFG))
    jds = jctr.CTRDataset(**dataclasses.asdict(DS))
    jcoll = jadapters.ctr_collection(jcfg, lr=5e-2,
                                     field_rows=jds.field_rows())
    tcoll = adapters.ctr_collection(CFG, lr=5e-2, field_rows=DS.field_rows())
    if backend != "dense":
        jcoll, tcoll = (c.with_backend(backend, cache) for c in (jcoll,
                                                                 tcoll))
    jcoll, tcoll = jcoll.with_shards(shards), tcoll.with_shards(shards)
    jt = jhybrid.PersiaTrainer(
        jadapters.recsys_adapter(jcfg, field_rows=jds.field_rows(),
                                 collection=jcoll),
        jm, jopt.OptConfig(kind="adam", lr=5e-3))
    tt = PersiaTrainer(
        adapters.recsys_adapter(CFG, field_rows=DS.field_rows(),
                                collection=tcoll),
        tm, OptConfig(kind="adam", lr=5e-3), device="cpu")
    return jt, tt


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _carry(tt, jt, js):
    """The port's state from a JAX sharded state: dense tables as their
    shards' arrays, host_lru tables as the router's checkpoint blob."""
    emb = {n: jbackend.unwrap(b).state_for_checkpoint(js.emb[n])
           if isinstance(jbackend.unwrap(b).shard_backends[0],
                         jbackend.HostLRUBackend)
           else _to_np(js.emb[n]) for n, b in jt.backends.items()}
    return convert.state_from_numpy(
        tt, _to_np(js.dense), emb, opt=_to_np(js.opt),
        emb_queue=_to_np(js.emb_queue), dense_queue=_to_np(js.dense_queue),
        step=int(js.step))


def _check_sharded(tt, ts, jt, js):
    """The FFNN's class for the dense side, tables, accumulators and
    queued grads, shard by shard; queue ids, slots, rings, slot maps and
    counters exactly."""
    got, want = convert.state_to_numpy(ts), _to_np(js)
    assert int(got["step"]) == int(want.step)
    for g, w in zip(jax.tree.leaves(got["dense"]),
                    jax.tree.leaves(want.dense)):
        _close(g, w, 1e-5, 1e-6, "dense")
    for k, rtol, atol in (("m", 1e-4, 1e-8), ("v", 1e-4, 1e-12)):
        for g, w in zip(jax.tree.leaves(got["opt"][k]),
                        jax.tree.leaves(want.opt[k])):
            _close(g, w, rtol, atol, f"adam {k}")
    for n in want.emb:
        tb, jb = BK.unwrap(tt.backends[n]), jbackend.unwrap(jt.backends[n])
        assert sorted(got["emb"][n]) == sorted(want.emb[n])
        for s, (tsub, jsub) in enumerate(zip(tb.shard_backends,
                                             jb.shard_backends)):
            gs, ws = got["emb"][n][f"s{s}"], want.emb[n][f"s{s}"]
            _close(gs["table"], ws["table"], 1e-5, 1e-6, f"{n} s{s}")
            _close(gs["acc"], ws["acc"], 1e-5, 1e-9, f"{n} s{s} acc")
            if "slot_ids" in ws:
                np.testing.assert_array_equal(gs["slot_ids"], ws["slot_ids"])
                np.testing.assert_array_equal(tsub._id_for_slot,
                                              jsub._id_for_slot)
                assert (tsub.faults, tsub.writebacks, tsub.hits) == \
                    (jsub.faults, jsub.writebacks, jsub.hits)
                _close(tsub.store.vectors, jsub.store.vectors, 1e-5, 1e-6,
                       f"{n} s{s} store")
            gq, wq = got["emb_queue"][n], want.emb_queue[n]
            assert (gq is None) == (wq is None)
            if wq is None:
                continue
            gq, wq = gq[f"s{s}"], wq[f"s{s}"]
            for k in ("ids", "slots"):
                if k in wq:
                    np.testing.assert_array_equal(gq[k], wq[k])
            assert (int(gq["ptr"]), int(gq["filled"])) == \
                (int(wq["ptr"]), int(wq["filled"]))
            _close(gq["grads"], wq["grads"], 1e-5, 1e-6, f"{n} s{s} queue")


@pytest.mark.parametrize("mode,backend,cache", [
    ("sync", "dense", None), ("hybrid", "dense", None),
    ("async", "dense", None), ("hybrid", "host_lru", RPF // 2)],
    ids=["sync", "hybrid", "async", "hybrid-host_lru"])
def test_sharded_training_matches_jax(mode, backend, cache):
    """The port's 4-shard trainer against JAX's from one JAX-exported
    state, 4 steps alternating ``step`` and ``decomposed_step``."""
    jt, tt = _pair(mode, backend, cache)
    batches = _batches(4, seed=5)
    js = jt.init(jax.random.PRNGKey(0), _jnp(batches[0]))
    ts = _carry(tt, jt, js)
    for i, b in enumerate(batches):
        how = "step" if i % 2 == 0 else "decomposed_step"
        js, jm = getattr(jt, how)(js, _jnp(b))
        ts, tm = getattr(tt, how)(ts, b)
        _close(float(tm["loss"]), float(jm["loss"]), 1e-5, 0, "loss")
        for k, v in jm.items():
            if k.startswith("shard/"):
                assert tm[k] == pytest.approx(float(v)), k
    _check_sharded(tt, ts, jt, js)


@pytest.mark.parametrize("backend,cache", [("dense", None),
                                           ("host_lru", RPF // 2)],
                         ids=["dense", "host_lru"])
def test_jax_sharded_checkpoint_round_trips_through_the_port(backend, cache,
                                                             tmp_path):
    """A JAX 4-shard checkpoint restores into the port leaf for leaf; the
    port saves it back with the same key paths, dtypes and shapes, and
    JAX restores that leaf for leaf; every logical row equal."""
    from test_torch_train import _manifest
    jt, tt = _pair("hybrid", backend, cache)
    batches = _batches(3, seed=2)
    js = jt.init(jax.random.PRNGKey(1), _jnp(batches[0]))
    for b in batches:
        js, _ = jt.step(js, _jnp(b))
    jt.save(str(tmp_path / "j"), js)
    ts = tt.restore(str(tmp_path / "j"))
    got = convert.state_to_numpy(ts)
    want = _to_np({"dense": js.dense, "opt": js.opt, "emb": js.emb,
                   "emb_queue": js.emb_queue})
    for k in want:
        for g, w in zip(jax.tree.leaves(got[k]), jax.tree.leaves(want[k])):
            np.testing.assert_array_equal(g, w)
    tt.save(str(tmp_path / "t"), ts)
    assert _manifest(tmp_path / "t") == _manifest(tmp_path / "j")
    assert checkpoint_shard_layout(str(tmp_path / "t")) == \
        jcheckpoint_shard_layout(str(tmp_path / "j"))
    jt2, _ = _pair("hybrid", backend, cache)
    back = _to_np(jt2.restore(str(tmp_path / "t")))
    for g, w in zip(jax.tree.leaves({"emb": back.emb,
                                     "emb_queue": back.emb_queue}),
                    jax.tree.leaves({"emb": want["emb"],
                                     "emb_queue": want["emb_queue"]})):
        np.testing.assert_array_equal(g, w)
    # every logical row of every table, through the reshard extractor
    for n in tt.collection.names:
        blob = BK.unwrap(tt.backends[n]).state_for_checkpoint(ts.emb[n])
        jblob = jbackend.unwrap(jt.backends[n]).state_for_checkpoint(
            js.emb[n])
        spec = tt.collection[n]
        base = "dense" if backend == "dense" else "host_lru"
        for a, b in zip(BK.extract_logical_rows(blob, spec, base),
                        jbackend.extract_logical_rows(
                            jblob, jt.collection[n], base)):
            np.testing.assert_array_equal(a, b)


def test_checkpoint_shard_layout_equals_jax(tmp_path):
    """Both packages read the same layout off a mixed checkpoint (one
    table on 2 shards, one plain) and refuse the same corrupt blob."""
    tr = _trainer("host_lru", RPF, tau=0)
    state = tr.init(0, _batches(1)[0], emb_shards={"field_00": 2})
    tr.save(str(tmp_path), state)
    assert checkpoint_shard_layout(str(tmp_path)) == \
        jcheckpoint_shard_layout(str(tmp_path)) == \
        {"field_00": 2, "field_01": 1}
    with pytest.raises(ValueError, match="no per-table"):
        from repro_torch.checkpoint import save_checkpoint
        save_checkpoint(str(tmp_path / "x"), 1, {"a": np.zeros(2)})
        checkpoint_shard_layout(str(tmp_path / "x"))


def test_router_reads_and_wire_match_one_shard():
    """read_pooled_all and read_rows over a 4-shard router (dense,
    host_lru with misses, behind the wire) equal one shard's bit for bit,
    with the same read gauges."""
    batches = _batches(4)
    for backend, cache in (("dense", None), ("host_lru", 48),
                           ("host_lru+compressed", 48)):
        t1 = _trainer(backend, cache, shards=1, tau=0)
        t4 = _trainer(backend, cache, shards=4, tau=0)
        s1, s4 = t1.init(0, batches[0]), t4.init(0, batches[0])
        for b in batches[:2]:
            s1, _ = t1.step(s1, b)
            s4, _ = t4.step(s4, b)
        ids = t1.adapter.emb_ids(batches[3])
        p1, i1 = BK.read_pooled_all(t1.backends, s1.emb, ids, "cpu")
        p4, i4 = BK.read_pooled_all(t4.backends, s4.emb, ids, "cpu")
        for n in p1:
            np.testing.assert_array_equal(p1[n].numpy(), p4[n].numpy())
            r1, _ = t1.backends[n].read_rows(s1.emb[n], ids[n])
            r4, _ = t4.backends[n].read_rows(s4.emb[n], ids[n])
            np.testing.assert_array_equal(r1.numpy(), r4.numpy())
        if "host_lru" in backend:
            assert i1 == i4 and sum(v["misses"] for v in i4.values()) > 0
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(s1.dense), tree_leaves(s4.dense)))
