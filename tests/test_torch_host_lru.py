"""The port's out-of-core tier (repro_torch HostLRUBackend, host_lru and
host_lru+disk, alone and behind the compressed wire) against the JAX
package on the CPU, from the same numpy inputs and the same state.

Tolerance classes (stated per comparison below):
* bit-exact: the copied numpy modules (``lru``, ``hotness``,
  ``mmap_store``: equal arrays and equal serialized blobs), slot maps,
  ``faults``/``writebacks``/``hits``/admission counters, queue ``slots``,
  ``ids``, ``ptr`` and ``filled``, device ``slot_ids``, the host store's
  keys and recency, checkpoint round trips, and the port against itself
  (host_lru against dense with no shuffle collision, ``+disk`` against
  the two-tier store);
* allclose, the FFNN's class of ``test_torch_train._check_states``: tables,
  accumulators, host-store rows and the loss after the dense products,
  whose reduction order differs between XLA and torch (tables and rows
  rtol 1e-5 atol 1e-6, accumulators rtol 1e-5 atol 1e-9);
* reads: hits and misses equal exactly, pooled rows rtol 1e-6 atol 1e-7
  (a sum of the same fp32 rows in another order);
* behind the wire, ``_close_lossy`` (an element may move by one fp16 step
  of its block).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import adapters as jadapters
from repro.core import backend as jbackend
from repro.core import hybrid as jhybrid
from repro.core import lru as jlru
from repro.core import mmap_store as jmmap
from repro.core.embedding_ps import EmbeddingSpec as JSpec
from repro.core.hotness import HotnessSketch as JSketch
from repro.data import ctr as jctr
from repro.launch import serve as jserve
from repro.optim import optimizers as jopt

from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.core import adapters, backend, lru, mmap_store
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.core.hotness import HotnessSketch
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.data import ctr
from repro_torch.launch import serve as tserve
from repro_torch.optim import optimizers as topt

from test_torch_train import _check_states, _close, _close_lossy, _to_np

F, RPF, D, B, L = 3, 400, 8, 16, 4
CFG = tbase.ModelConfig(name="lru", arch_type="recsys", n_id_fields=F,
                        ids_per_field=L, emb_dim=D, emb_rows=F * RPF,
                        n_dense_features=4, mlp_dims=(16,), n_tasks=2)
DS = ctr.CTRDataset("lru", n_rows=F * RPF, n_fields=F, ids_per_field=L,
                    n_dense=4, n_tasks=2)
EMB_LR, DENSE_LR = 5e-2, 3e-3
MODES = {"sync": ((), ()), "hybrid": ((2,), (2,)), "async": ((2, 2), (2, 2))}


def _modes(name):
    j = {"sync": jhybrid.TrainMode.sync, "hybrid": jhybrid.TrainMode.hybrid,
         "async": jhybrid.TrainMode.async_}[name]
    t = {"sync": TrainMode.sync, "hybrid": TrainMode.hybrid,
         "async": TrainMode.async_}[name]
    return j(*MODES[name][0]), t(*MODES[name][1])


def _trainers(mode, backend_name="host_lru", cache_rows=RPF // 8, **kw):
    """A JAX and a port trainer over the same host_lru collection."""
    jm, tm = _modes(mode)
    jcfg = JConfig(**dataclasses.asdict(CFG))
    jds = jctr.CTRDataset(**dataclasses.asdict(DS))
    jcoll = jadapters.ctr_collection(jcfg, lr=EMB_LR,
                                     field_rows=jds.field_rows()) \
        .with_backend(backend_name, cache_rows) \
        .map_specs(lambda _, s: dataclasses.replace(s, **kw))
    tcoll = adapters.ctr_collection(CFG, lr=EMB_LR,
                                    field_rows=DS.field_rows()) \
        .with_backend(backend_name, cache_rows) \
        .map_specs(lambda _, s: dataclasses.replace(s, **kw))
    jt = jhybrid.PersiaTrainer(
        jadapters.recsys_adapter(jcfg, field_rows=jds.field_rows(),
                                 collection=jcoll),
        jm, jopt.OptConfig(kind="adam", lr=DENSE_LR))
    tt = PersiaTrainer(
        adapters.recsys_adapter(CFG, field_rows=DS.field_rows(),
                                collection=tcoll),
        tm, topt.OptConfig(kind="adam", lr=DENSE_LR), device="cpu")
    return jt, tt


def _batches(n, seed=5, batch=B):
    it = DS.sampler(batch, seed=seed)
    return [next(it) for _ in range(n)]


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _blobs(trainer, emb):
    """Every table's checkpoint blob (device cache + host tiers)."""
    return {n: backend.unwrap(b).state_for_checkpoint(emb[n])
            if isinstance(b, backend.EmbeddingBackend)
            else jbackend.unwrap(b).state_for_checkpoint(emb[n])
            for n, b in trainer.backends.items()}


def _carry(tt, jt, js):
    """The port's state from a JAX host_lru state, through numpy: the
    caches, host stores and slot maps as checkpoint blobs."""
    return convert.state_from_numpy(
        tt, _to_np(js.dense), _blobs(jt, js.emb), opt=_to_np(js.opt),
        emb_queue=_to_np(js.emb_queue), dense_queue=_to_np(js.dense_queue),
        step=int(js.step))


def _check_tiers(tt, ts, jt, js):
    """Slot maps, counters, queue slots and device slot ids exactly; host
    stores' rows in the FFNN's class, their keys exactly."""
    for n in tt.collection.names:
        tb, jb = backend.unwrap(tt.backends[n]), jbackend.unwrap(
            jt.backends[n])
        np.testing.assert_array_equal(tb._id_for_slot, jb._id_for_slot)
        np.testing.assert_array_equal(tb._slot_arr, jb._slot_arr)
        np.testing.assert_array_equal(tb._slot_clock, jb._slot_clock)
        assert tb._slot_for_id == jb._slot_for_id
        assert (tb.faults, tb.writebacks, tb.hits, tb.admits, tb.bypasses,
                tb.promotes) == (jb.faults, jb.writebacks, jb.hits,
                                 jb.admits, jb.bypasses, jb.promotes), n
        np.testing.assert_array_equal(ts.emb[n]["slot_ids"].numpy(),
                                      np.asarray(js.emb[n]["slot_ids"]))
        gq, wq = ts.emb_queue[n], js.emb_queue[n]
        if wq is not None:
            np.testing.assert_array_equal(gq["slots"].numpy(),
                                          np.asarray(wq["slots"]))
        gs, ws = tb.store.serialize(), jb.store.serialize()
        _store_close(gs, ws, n)


def _store_close(gs, ws, what):
    if "disk" in ws:
        _store_close(gs["host"], ws["host"], what + " host")
        _store_close(gs["disk"], ws["disk"], what + " disk")
        return
    assert set(gs) == set(ws), what
    for k in ws:
        if k == "vectors":
            _close(gs[k], ws[k], 1e-5, 1e-6, f"{what} store {k}")
        elif k == "opt_acc":
            _close(gs[k], ws[k], 1e-5, 1e-9, f"{what} store {k}")
        elif k not in ("vec16", "vec16_scale"):
            np.testing.assert_array_equal(gs[k], ws[k], err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# the copied numpy modules
# ---------------------------------------------------------------------------

def _assert_blobs_equal(a, b, what=""):
    assert set(a) == set(b), what
    for k in a:
        if isinstance(a[k], dict):
            _assert_blobs_equal(a[k], b[k], f"{what}/{k}")
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}/{k}")


@pytest.mark.parametrize("store_dtype", ["fp32", "blockscale16"])
def test_lru_store_copy_equals_jax(store_dtype):
    rng = np.random.default_rng(0)
    stores = [m.LRUEmbeddingStore(48, 136, store_dtype=store_dtype)
              for m in (lru, jlru)]
    for step in range(12):
        ids = rng.integers(0, 200, 20)
        outs = []
        for s in stores:
            if step % 3 == 0:
                outs.append(s.get(ids))
                s.put(ids, np.full((20, 136), 0.5, np.float32))
            elif step % 3 == 1:
                outs.append(s.read_rows(ids)[0])
            else:
                s.write_rows(ids[:5], np.linspace(-3, 3, 5 * 136, dtype=
                                                  np.float32).reshape(5, 136),
                             np.arange(5, dtype=np.float32))
                outs.append(np.asarray(s.recency_ids()))
        np.testing.assert_array_equal(outs[0], outs[1])
    _assert_blobs_equal(stores[0].serialize(), stores[1].serialize())
    rows = rng.standard_normal((7, 300)).astype(np.float32) * 40
    for a, b in zip(lru.bs_compress_rows(rows), jlru.bs_compress_rows(rows)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        lru.bs_decompress_rows(*lru.bs_compress_rows(rows)),
        jlru.bs_decompress_rows(*jlru.bs_compress_rows(rows)))
    back = lru.LRUEmbeddingStore.deserialize(stores[1].serialize())
    _assert_blobs_equal(back.serialize(), stores[1].serialize())


def test_hotness_sketch_copy_equals_jax():
    rng = np.random.default_rng(1)
    sk = [cls(width=256, depth=3, decay=0.5, decay_every=4, seed=9)
          for cls in (HotnessSketch, JSketch)]
    for _ in range(9):
        ids, counts = rng.integers(0, 300, 25), rng.integers(1, 4, 25)
        for s in sk:
            s.update(ids, counts.astype(np.float64))
        probe = np.arange(-2, 320)
        np.testing.assert_array_equal(sk[0].estimate(probe),
                                      sk[1].estimate(probe))
    _assert_blobs_equal(sk[0].serialize(), sk[1].serialize())


def test_mmap_and_tiered_store_copies_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    stores = [m.TieredHostStore(300, 16, host_rows=40,
                                path=str(tmp_path / name))
              for m, name in ((mmap_store, "t"), (jmmap, "j"))]
    for _ in range(10):
        ids = rng.integers(0, 300, 30)
        got = [s.read_rows(ids) for s in stores]
        for a, b in zip(*got):
            np.testing.assert_array_equal(a, b)
        w = rng.standard_normal((6, 16)).astype(np.float32)
        for s in stores:
            s.write_rows(ids[:6], w, np.ones(6, np.float32))
    assert stores[0].spills == stores[1].spills > 0
    assert stores[0].promotions == stores[1].promotions > 0
    a, b = stores[0].serialize(), stores[1].serialize()
    _assert_blobs_equal(a, b)
    back = mmap_store.TieredHostStore.deserialize(b, path=str(tmp_path / "r"))
    _assert_blobs_equal(back.serialize(), b)


# ---------------------------------------------------------------------------
# spec, collection, factory
# ---------------------------------------------------------------------------

def test_spec_fields_and_collection_overrides_match_jax():
    for f in ("cache_rows", "store_dtype", "admit_threshold", "bypass_rows",
              "host_rows", "disk_path"):
        assert getattr(EmbeddingSpec(rows=4, dim=2), f) == \
            getattr(JSpec(rows=4, dim=2), f), f
    coll = adapters.ctr_collection(CFG, field_rows=DS.field_rows())
    c2 = coll.with_backend("host_lru+disk", 64).with_store_dtype(
        "blockscale16")
    for _, s in c2.items():
        assert (s.backend, s.cache_rows, s.store_dtype) == \
            ("host_lru+disk", 64, "blockscale16")
    assert coll.with_backend("dense")["field_00"].cache_rows == 0
    with pytest.raises(ValueError, match="cache_rows > 0"):
        backend.create_backend(EmbeddingSpec(rows=4, dim=2,
                                              backend="host_lru"))
    with pytest.raises(ValueError, match="store_dtype"):
        backend.create_backend(EmbeddingSpec(rows=4, dim=2,
                                             store_dtype="blockscale16"))
    with pytest.raises(ValueError, match="unknown store_dtype"):
        backend.create_backend(EmbeddingSpec(
            rows=4, dim=2, backend="host_lru", cache_rows=2,
            store_dtype="int8"))


# ---------------------------------------------------------------------------
# training against the JAX host_lru trainer, from one state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", [RPF, RPF // 8], ids=["fits", "evicts"])
@pytest.mark.parametrize("mode", ["sync", "hybrid", "async"])
def test_host_lru_training_matches_jax(mode, cache):
    jt, tt = _trainers(mode, cache_rows=cache)
    batches = _batches(4)
    js = jt.init(jax.random.PRNGKey(0), _jnp(batches[0]))
    ts = _carry(tt, jt, js)
    for i, b in enumerate(batches):
        how = "step" if i % 2 == 0 else "decomposed_step"
        js, jm = getattr(jt, how)(js, _jnp(b))
        ts, tm = getattr(tt, how)(ts, b)
        _close(float(tm["loss"]), float(jm["loss"]), 1e-5, 0, "loss")
        for k, v in jm.items():
            if k.startswith(("dedup/", "cache/")):
                assert tm[k] == pytest.approx(float(v)), k
    _check_states(ts, js)
    _check_tiers(tt, ts, jt, js)
    bk = backend.unwrap(tt.backends["field_00"])
    assert bk.faults > 0
    if cache < RPF:
        assert bk.writebacks > 0 and bk.faults > cache
        assert bk.device_bytes(ts.emb["field_00"]) < bk.host_bytes()
    else:
        assert bk.writebacks == 0
    # eval reads the host tier without faulting, as the JAX trainer's
    faults = bk.faults
    _close(float(tt.eval(ts, batches[0])["loss"]),
           float(jt.eval(js, _jnp(batches[0]))["loss"]), 1e-5, 0, "eval")
    assert bk.faults == faults


def test_admission_training_matches_jax():
    """With the admission sketch on, the bypass slots, promotions and the
    ``cache/<table>/{admit,bypass,promote}`` step gauges equal JAX's."""
    jt, tt = _trainers("hybrid", admit_threshold=1.5, bypass_rows=8)
    batches = _batches(4)
    js = jt.init(jax.random.PRNGKey(3), _jnp(batches[0]))
    ts = _carry(tt, jt, js)
    seen = set()
    for b in batches:
        js, jm = jt.decomposed_step(js, _jnp(b))
        ts, tm = tt.decomposed_step(ts, b)
        _close(float(tm["loss"]), float(jm["loss"]), 1e-5, 0, "loss")
        cache = {k: float(v) for k, v in jm.items() if k.startswith("cache/")}
        assert cache and {k: tm[k] for k in cache} == cache
        seen |= {k.rsplit("/", 1)[1] for k, v in cache.items() if v > 0}
    assert seen == {"admit", "bypass", "promote"}
    _check_states(ts, js)
    _check_tiers(tt, ts, jt, js)


def test_flat_host_lru_training_matches_jax():
    """``batch_dedup=False``: occurrence-width slots, an occurrence-width
    queue of (slot, id, grad), puts grouped by slot on the device."""
    jt, tt = _trainers("hybrid", batch_dedup=False)
    batches = _batches(4)
    js = jt.init(jax.random.PRNGKey(2), _jnp(batches[0]))
    ts = _carry(tt, jt, js)
    assert ts.emb_queue["field_00"]["slots"].shape == (2, B * L)
    for b in batches:
        js, jm = jt.decomposed_step(js, _jnp(b))
        ts, tm = tt.decomposed_step(ts, b)
        _close(float(tm["loss"]), float(jm["loss"]), 1e-5, 0, "loss")
    _check_states(ts, js)
    _check_tiers(tt, ts, jt, js)
    assert backend.unwrap(tt.backends["field_01"]).writebacks > 0


def test_host_lru_bit_exact_with_dense_without_shuffle_collision():
    """cache_rows == rows and ids < 4,295 (no two share a shuffled row):
    the port's host_lru table must train bit for bit like its dense one,
    from the same seed (its init parks the dense draw host-side)."""
    batches = _batches(6, batch=32)
    _, td = _trainers("hybrid", backend_name="dense", cache_rows=None)
    _, th = _trainers("hybrid", cache_rows=RPF)
    sd = td.init(seed=0, batch_example=batches[0])
    sh = th.init(seed=0, batch_example=batches[0])
    for b in batches:
        sd, md = td.step(sd, b)
        sh, mh = th.decomposed_step(sh, b)
        assert float(md["loss"]) == float(mh["loss"])
    probe = {"ids": np.tile(np.arange(RPF)[None, None, :], (1, F, 1)),
             "dense": np.zeros((1, 4), np.float32)}
    rd, rh = td.lookup(sd, probe), th.lookup(sh, probe)
    for n in rd:
        assert torch.equal(rd[n], rh[n]), n
    assert float(td.eval(sd, batches[0])["loss"]) == \
        float(th.eval(sh, batches[0])["loss"])


def test_host_lru_rejects_oversized_working_set():
    _, tt = _trainers("sync", cache_rows=4)
    b = _batches(1, batch=64)[0]
    state = tt.init(seed=0, batch_example=b)
    with pytest.raises(ValueError, match="working set"):
        tt.step(state, b)


@pytest.mark.parametrize("port", [True, False], ids=["port", "jax"])
def test_stale_put_to_recycled_slot_is_dropped(port):
    """tau-stale puts whose cache slot was recycled for another row are
    dropped (the paper's tolerated lost put), in both packages alike."""
    if port:
        mk, g, z = backend.create_backend, torch.full((2, 2), 7.0), \
            torch.zeros((2, 2))
        spec = EmbeddingSpec(rows=4, dim=2, mode="full", optimizer="sgd",
                             lr=1.0, staleness=1, backend="host_lru",
                             cache_rows=2)
        init = lambda b: b.init(torch.Generator().manual_seed(0))  # noqa
        prep = lambda b, s, a: b.prepare(s, a)                     # noqa
        dev = lambda x: torch.from_numpy(np.asarray(x))            # noqa
    else:
        mk, g, z = jbackend.create_backend, jnp.full((2, 2), 7.0), \
            jnp.zeros((2, 2))
        spec = JSpec(rows=4, dim=2, mode="full", optimizer="sgd", lr=1.0,
                     staleness=1, backend="host_lru", cache_rows=2)
        init = lambda b: b.init(jax.random.PRNGKey(0))             # noqa
        prep = lambda b, s, a: b.prepare(s, a)                     # noqa
        dev = jnp.asarray
    bk = mk(spec)
    state = init(bk)
    queue = bk.queue_init((2,))
    state, d0 = prep(bk, state, np.array([0, -1]))
    state, queue, _ = bk.hybrid_update(state, queue, dev(d0), g)
    state, d12 = prep(bk, state, np.array([1, 2]))
    assert 0 not in bk._slot_for_id
    before = np.array(state["table"]).copy()
    state, queue, _ = bk.hybrid_update(state, queue, dev(d12), z)
    np.testing.assert_array_equal(np.asarray(state["table"]), before)
    # control: without the recycle, the put lands on id 0's row
    bk2 = mk(dataclasses.replace(spec, cache_rows=4))
    st2 = init(bk2)
    q2 = bk2.queue_init((2,))
    st2, d0 = prep(bk2, st2, np.array([0, -1]))
    st2, q2, _ = bk2.hybrid_update(st2, q2, dev(d0), g)
    row_before = np.array(bk2.lookup(st2, dev(d0))[0][0]).copy()
    st2, q2, _ = bk2.hybrid_update(st2, q2, dev(d0), z)
    np.testing.assert_allclose(np.asarray(bk2.lookup(st2, dev(d0))[0][0]),
                               row_before - 7.0, atol=1e-6)


# ---------------------------------------------------------------------------
# admission and the +disk tier, against the JAX backend
# ---------------------------------------------------------------------------

ROWS, DIM, CACHE, BYPASS = 512, 8, 32, 8


def _pair(backend_name="host_lru", **kw):
    """The same spec as a JAX and a port backend, from one JAX state."""
    jspec = JSpec(rows=ROWS, dim=DIM, backend=backend_name,
                  cache_rows=CACHE, **kw)
    jb = jbackend.create_backend(jspec)
    js = jb.init(jax.random.PRNGKey(0))
    kw = {k: (v + "_port" if k == "disk_path" else v) for k, v in kw.items()}
    tb = backend.create_backend(EmbeddingSpec(
        rows=ROWS, dim=DIM, backend=backend_name, cache_rows=CACHE, **kw))
    ts = convert.table_from_numpy(tb, jb.state_for_checkpoint(js), "cpu")
    return jb, js, tb, ts


def _same(jb, js, tb, ts, jd, td):
    np.testing.assert_array_equal(np.asarray(jd), td)
    for k in js:
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy(), k)
    assert (jb.faults, jb.writebacks, jb.hits, jb.admits, jb.bypasses,
            jb.promotes) == (tb.faults, tb.writebacks, tb.hits, tb.admits,
                             tb.bypasses, tb.promotes)
    assert jb.cache_metrics() == tb.cache_metrics()


def test_admission_bypass_then_promote_matches_jax():
    jb, js, tb, ts = _pair(admit_threshold=1.5, bypass_rows=BYPASS)
    assert tb.dev_slots == CACHE + BYPASS
    ids = np.arange(4)
    js, jd = jb.prepare(js, ids)
    ts, td = tb.prepare(ts, ids)
    _same(jb, js, tb, ts, jd, td)
    assert np.all(td >= CACHE)                     # first sight: bypassed
    assert tb.cache_metrics() == {"admit": 0.0, "bypass": 4.0,
                                  "promote": 0.0}
    js, jd = jb.prepare(js, ids)
    ts, td = tb.prepare(ts, ids)
    _same(jb, js, tb, ts, jd, td)
    assert np.all((td >= 0) & (td < CACHE))        # second sight: promoted
    assert tb.promotes == 4 and tb.writebacks == 4
    # a cold burst wider than the bypass region overflows into main
    burst = 200 + np.arange(BYPASS + 6)
    js, jd = jb.prepare(js, burst)
    ts, td = tb.prepare(ts, burst)
    _same(jb, js, tb, ts, jd, td)
    assert tb.last_bypass == BYPASS and tb.last_admit == 6
    assert np.unique(td).size == burst.size


def test_disk_tier_bit_equal_to_two_tier(tmp_path):
    """The disk tier changes where cold rows live, never what they hold:
    the same fault and put stream gives the same slots and values, while
    the tiered store spills and promotes; and the JAX +disk backend gives
    the same slots too."""
    _, _, b2, s2 = _pair("host_lru")
    jb3, js3, b3, s3 = _pair("host_lru+disk", host_rows=64,
                             disk_path=str(tmp_path / "tier"))
    rng = np.random.default_rng(3)
    for _ in range(12):
        ids = rng.integers(0, ROWS, (4, 6))
        s2, d2 = b2.prepare(s2, ids)
        s3, d3 = b3.prepare(s3, ids)
        js3, jd3 = jb3.prepare(js3, ids)
        np.testing.assert_array_equal(d2, d3)
        np.testing.assert_array_equal(np.asarray(jd3), d3)
        a2, _ = b2.lookup(s2, torch.from_numpy(d2))
        a3, _ = b3.lookup(s3, torch.from_numpy(d3))
        assert torch.equal(a2, a3)
        g = torch.from_numpy(rng.standard_normal((24, DIM)).astype(
            np.float32))
        s2, _ = b2.apply_put(s2, torch.from_numpy(d2).reshape(-1), g)
        s3, _ = b3.apply_put(s3, torch.from_numpy(d3).reshape(-1), g)
    assert b2.faults == b3.faults == jb3.faults
    assert b3.store.spills > 0 and b3.store.promotions > 0


# ---------------------------------------------------------------------------
# checkpoints: both ways, across store formats and store dtypes
# ---------------------------------------------------------------------------

def _manifest(path):
    from test_torch_train import _manifest as m
    return m(path)


def test_jax_host_lru_checkpoint_restores_into_the_port(tmp_path):
    jt, tt = _trainers("async")
    batches = _batches(3)
    js = jt.init(jax.random.PRNGKey(1), _jnp(batches[0]))
    for b in batches:
        js, _ = jt.step(js, _jnp(b))
    jt.save(str(tmp_path / "j"), js)
    ts = tt.restore(str(tmp_path / "j"))
    got, want = convert.state_to_numpy(ts), _to_np(js)
    for g, w in zip(jax.tree.leaves({k: got[k] for k in
                                     ("dense", "opt", "emb", "emb_queue")}),
                    jax.tree.leaves({"dense": want.dense, "opt": want.opt,
                                     "emb": want.emb,
                                     "emb_queue": want.emb_queue})):
        np.testing.assert_array_equal(g, w)
    for n in tt.collection.names:
        _assert_blobs_equal(_blobs(tt, ts.emb)[n]["store"],
                            _blobs(jt, js.emb)[n]["store"])
    # the port writes the same key paths, dtypes and shapes
    tt.save(str(tmp_path / "t"), ts)
    assert _manifest(tmp_path / "t") == _manifest(tmp_path / "j")
    # and the two go on alike
    b = _batches(1, seed=9)[0]
    js, jm = jt.step(js, _jnp(b))
    ts, tm = tt.step(ts, b)
    _close(float(tm["loss"]), float(jm["loss"]), 1e-5, 0, "loss")
    _check_tiers(tt, ts, jt, js)


def test_port_host_lru_checkpoint_restores_into_jax(tmp_path):
    jt, tt = _trainers("hybrid")
    batches = _batches(4)
    ts = tt.init(seed=3, batch_example=batches[0])
    for b in batches:
        ts, _ = tt.step(ts, b)
    tt.save(str(tmp_path), ts)
    js = jt.restore(str(tmp_path))
    got = convert.state_to_numpy(ts)
    for g, w in zip(jax.tree.leaves({k: got[k] for k in
                                     ("dense", "opt", "emb", "emb_queue")}),
                    jax.tree.leaves(_to_np({"dense": js.dense,
                                            "opt": js.opt, "emb": js.emb,
                                            "emb_queue": js.emb_queue}))):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    for n in tt.collection.names:
        tb, jb = backend.unwrap(tt.backends[n]), jt.backends[n]
        np.testing.assert_array_equal(tb._id_for_slot, jb._id_for_slot)
        assert (tb.faults, tb.writebacks, tb.hits) == \
            (jb.faults, jb.writebacks, jb.hits)
        _assert_blobs_equal(tb.store.serialize(), jb.store.serialize())


@pytest.mark.parametrize("src,dst", [
    ("host_lru", "host_lru+disk"), ("host_lru+disk", "host_lru"),
    ("fp32", "blockscale16"), ("blockscale16", "fp32")])
def test_checkpoint_restores_across_store_formats(tmp_path, src, dst):
    """Two-tier <-> +disk and fp32 <-> blockscale16: the restored table
    reads every row as the saved one did (exactly across tiers; through
    the codec across dtypes), and the JAX backend restores the same blob
    to the same rows."""
    def spec(what, path):
        kw = dict(rows=ROWS, dim=DIM, cache_rows=CACHE)
        if what.startswith("host_lru"):
            kw["backend"] = what
            if what.endswith("disk"):
                kw.update(host_rows=64, disk_path=str(tmp_path / path))
        else:
            kw.update(backend="host_lru", store_dtype=what)
        return kw
    tb = backend.create_backend(EmbeddingSpec(**spec(src, "a")))
    ts = tb.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    for _ in range(8):
        ts, d = tb.prepare(ts, rng.integers(0, ROWS, 20))
        ts, _ = tb.apply_put(ts, torch.from_numpy(d), torch.from_numpy(
            rng.standard_normal((20, DIM)).astype(np.float32)))
    blob = tb.state_for_checkpoint(ts)

    def probe(b, st):
        # in chunks the +disk host tier holds (64 rows)
        out = [b.read_rows(st, np.arange(lo, lo + 32)[None, :])
               for lo in range(0, ROWS, 32)]
        rows = [np.asarray(r) for r, _ in out]
        return torch.from_numpy(np.concatenate(rows, 1)), \
            [i for _, i in out]
    want, _ = probe(tb, ts)
    t2 = backend.create_backend(EmbeddingSpec(**spec(dst, "b")))
    s2 = convert.table_from_numpy(t2, blob, "cpu")
    j2 = jbackend.create_backend(JSpec(**spec(dst, "c")))
    js2 = j2.restore_from_checkpoint(blob)
    got, info = probe(t2, s2)
    jgot, jinfo = probe(j2, js2)
    assert torch.equal(got, jgot)
    assert info == jinfo
    if "blockscale16" in (src, dst):
        # the cached rows are exact; a stored row crosses the codec once
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-6)
    else:
        assert torch.equal(got, want)
    for k in ts:
        np.testing.assert_array_equal(s2[k].numpy(), ts[k].numpy())


# ---------------------------------------------------------------------------
# the serve path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend_name,dedup", [
    ("host_lru", True), ("host_lru", False), ("host_lru+compressed", True)])
def test_read_pooled_all_matches_jax_read_rows(backend_name, dedup):
    """After training with evictions, a read hits some rows and misses
    others: the pooled bags equal JAX ``read_rows`` summed per bag, with
    equal hit and miss gauges, and the read changes no state."""
    jt, tt = _trainers("hybrid", backend_name=backend_name,
                       batch_dedup=dedup)
    batches = _batches(4)
    js = jt.init(jax.random.PRNGKey(0), _jnp(batches[0]))
    ts = _carry(tt, jt, js)
    for b in batches:
        js, _ = jt.step(js, _jnp(b))
        ts, _ = tt.step(ts, b)
    read = _batches(1, seed=11, batch=16)[0]
    read["ids"][3, 1] = -1                         # padding reads zero
    before = {n: backend.unwrap(b).faults for n, b in tt.backends.items()}
    pooled, info = tt.serve_lookup(ts, read)
    lossy = backend_name.endswith("compressed")
    misses = 0
    for i, n in enumerate(tt.collection.names):
        rows, jinfo = jt.backends[n].read_rows(js.emb[n], read["ids"][:, i])
        assert info[n] == jinfo, n
        misses += jinfo["misses"]
        if lossy:
            _close_lossy(pooled[n].numpy(), rows.sum(1), 1e-4, n)
        else:
            _close(pooled[n].numpy(), rows.sum(1), 1e-5, 1e-6, n)
        got_rows, ginfo = tt.backends[n].read_rows(ts.emb[n],
                                                   read["ids"][:, i])
        assert ginfo == jinfo
        (_close_lossy(got_rows.numpy(), rows, 1e-4, n) if lossy
         else _close(got_rows.numpy(), rows, 1e-5, 1e-6, n))
    assert misses > 0
    assert before == {n: backend.unwrap(b).faults
                      for n, b in tt.backends.items()}


def test_serving_service_counts_host_tier_misses():
    from repro_torch.serving import ServingConfig, ServingService, StateCell
    _, tt = _trainers("hybrid")
    batches = _batches(4)
    state = tt.init(seed=0, batch_example=batches[0])
    for b in batches:
        state, _ = tt.step(state, b)
    reqs = _batches(1, seed=13, batch=12)[0]
    cell = StateCell(state, state.step)
    with ServingService(tt, cell, ServingConfig(max_batch=4,
                                                max_wait_ms=1.0)) as svc:
        preds = svc.predict_many([{"ids": reqs["ids"][i],
                                   "dense": reqs["dense"][i]}
                                  for i in range(12)])
        m = svc.metrics()
    want = tt.predict(state, reqs).numpy()
    np.testing.assert_allclose(preds, want, rtol=1e-5, atol=1e-6)
    rates = [m[f"serving/{n}/hit_rate"] for n in tt.collection.names]
    assert all(0.0 <= r <= 1.0 for r in rates) and min(rates) < 1.0


def test_compressed_host_lru_lookups_and_puts_match_jax():
    """``host_lru+compressed``: the wire's gets and puts over cache slots,
    4 steps in hybrid mode against the JAX package (lossy class)."""
    jt, tt = _trainers("hybrid", backend_name="host_lru+compressed")
    batches = _batches(4)
    js = jt.init(jax.random.PRNGKey(0), _jnp(batches[0]))
    ts = _carry(tt, jt, js)
    # the wire's queue is as wide as the dedup cap over the device slots
    assert ts.emb_queue["field_00"]["slots"].shape == \
        tuple(np.shape(js.emb_queue["field_00"]["slots"]))
    for b in batches:
        js, jm = jt.decomposed_step(js, _jnp(b))
        ts, tm = tt.decomposed_step(ts, b)
        _close(float(tm["loss"]), float(jm["loss"]), 1e-5, 0, "loss")
        for k, v in jm.items():
            if k.startswith("wire/"):
                assert float(tm[k]) == pytest.approx(float(v)), k
    _check_states(ts, js, lossy=True)
    for n in tt.collection.names:
        tb, jb = backend.unwrap(tt.backends[n]), jbackend.unwrap(
            jt.backends[n])
        np.testing.assert_array_equal(tb._id_for_slot, jb._id_for_slot)
        assert (tb.faults, tb.writebacks) == (jb.faults, jb.writebacks)
        np.testing.assert_array_equal(
            ts.emb_queue[n]["slots"].numpy(),
            np.asarray(js.emb_queue[n]["slots"]))


def test_lm_serve_on_host_lru_matches_jax():
    """``launch.serve.serve(emb_backend="host_lru")`` from the JAX host_lru
    state: greedy tokens equal the JAX serve's (reduced granite, 2
    layers), and equal the port's own dense serve of the same rows."""
    from test_torch_lm import CFG as LCFG, CFG_J, _jax_state, _np_tree
    B_, P, G, seed = 2, 8, 6, 3
    dense, jb, emb = _jax_state(CFG_J, seed, "host_lru")
    dense_t = convert.lm_dense_from_numpy(_np_tree(dense), LCFG,
                                          device="cpu")
    want = jserve.serve(CFG_J, B_, P, G, seed=seed, emb_backend="host_lru")
    got = tserve.serve(LCFG, B_, P, G, seed=seed, emb_backend="host_lru",
                       device="cpu",
                       state=(jb.state_for_checkpoint(emb), dense_t))
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    _, _, emb_d = _jax_state(CFG_J, seed, "dense")
    spec = backend.EmbeddingSpec(rows=LCFG.vocab_size, dim=LCFG.d_model)
    ref = tserve.serve(LCFG, B_, P, G, seed=seed, device="cpu",
                       state=(convert.emb_from_numpy(_np_tree(emb_d), spec,
                                                     device="cpu"), dense_t))
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])


def test_launchers_accept_host_lru():
    from repro_torch.launch import shards
    spec = shards.build_embedding_spec(4096, 16, backend="host_lru+disk")
    assert spec.cache_rows == shards.default_cache_rows(4096)
    cfg = get_config("granite_3_2b", reduced=True).replace(
        pattern_repeats=1)
    res = tserve.serve(cfg, 1, 6, 3, emb_backend="host_lru+compressed",
                       cache_rows=1024, device="cpu")
    assert res["tokens"].shape == (1, 3)
