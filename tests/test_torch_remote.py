"""The port's multi-process embedding PS (repro_torch/net: ps_server,
remote, elastic) on the CPU, against threaded PS servers: the port's
remote training against the port's in-process training, and the remote
slice against the JAX package's in-process trainer.

Tolerance classes:
* bit-exact: remote against in-process in the port (the PS runs the
  port's own backend ops eagerly, as the in-process trainer does): losses,
  dense parameters, and every logical row and accumulator, for dense and
  host_lru x sync / hybrid(2) / async(2, 2), one endpoint and the router
  at k = 2 and 3, the lossy wire at k = 1 against ``dense+compressed``,
  the pipelined trainer, the blocking transport, checkpoint round trips;
* against JAX (the remote slice from a JAX-exported state against the
  JAX package's in-process trainer): the port's in-process class, rtol
  1e-5 / atol 1e-6 for losses, dense parameters, rows and accumulators
  (as ``tests/test_torch_sharded.py``), since torch and XLA round the
  FFNN differently; the JAX package's own remote-against-in-process
  class (rtol 1e-6 / atol 1e-8) does not hold for the port (see
  ``test_remote_slice_against_jax_in_process``);
* invariants where threads decide the order (elastic recovery): finite
  losses, membership, zero lost rows."""
import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import adapters as jadapters
from repro.core import hybrid as jhybrid
from repro.data import ctr as jctr
from repro.optim import optimizers as jopt

from repro_torch import convert
from repro_torch.checkpoint import checkpoint_shard_layout
from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapters
from repro_torch.core import backend as BK
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.core.pipeline import PipelinedTrainer
from repro_torch.data.ctr import CTRDataset
from repro_torch.net import (ClusterDeadError, ElasticPSCluster,
                             HeartbeatMonitor, PSMember, PSUnavailableError,
                             RemoteBackend, RemoteShardedBackend,
                             connect_remote_backends, is_ps_failure, remote)
from repro_torch.net.ps_server import PSServer, read_spool
from repro_torch.optim.optimizers import OptConfig
from repro_torch.serving import StateCell
from repro_torch.utils import tree_leaves

from test_torch_train import _close, _to_np

F, RPF, D = 2, 64, 8

CFG = ModelConfig(name="rps", arch_type="recsys", n_id_fields=F,
                  ids_per_field=3, emb_dim=D, emb_rows=F * RPF,
                  n_dense_features=4, mlp_dims=(16,), n_tasks=1)
DS = CTRDataset("rps", n_rows=F * RPF, n_fields=F, ids_per_field=3,
                n_dense=4)
MODES = {"sync": TrainMode.sync(), "hybrid": TrainMode.hybrid(2),
         "async": TrainMode.async_(2, 2)}


def _batches(n, batch=16, seed=0):
    it = DS.sampler(batch, seed=seed)
    return [next(it) for _ in range(n)]


def _trainer(backend="dense", cache_rows=None, mode="hybrid", tau=2,
             shards=1, batch_dedup=None):
    coll = adapters.ctr_collection(CFG, lr=5e-2, field_rows=DS.field_rows())
    if backend != "dense":
        coll = coll.with_backend(backend, cache_rows)
    if shards != 1:
        coll = coll.with_shards(shards)
    ad = adapters.recsys_adapter(CFG, field_rows=DS.field_rows(),
                                 collection=coll)
    m = MODES[mode] if mode != "hybrid" else TrainMode.hybrid(tau)
    return PersiaTrainer(ad, m, OptConfig(kind="adam", lr=5e-3),
                         batch_dedup=batch_dedup, device="cpu")


@pytest.fixture
def servers():
    """Threaded PS servers on the CPU with per-server spool dirs; stopped,
    and every pooled client closed, at teardown."""
    started = []

    def make(n, spool_root=None):
        for i in range(n):
            sd = None
            if spool_root is not None:
                sd = os.path.join(str(spool_root), f"ps{len(started)}")
            started.append(PSServer(spool_dir=sd, device="cpu").start())
        return started[-n:]

    yield make
    for s in started:
        s.stop()
    with remote._POOL_LOCK:
        clients = [c for c, _ in remote._CLIENT_POOL.values()]
        remote._CLIENT_POOL.clear()
    for c in clients:
        c.close()


def _endpoints(srvs):
    return [("127.0.0.1", s.port) for s in srvs]


def _rows(trainer, state):
    """Every table's logical rows and accumulators, off its checkpoint
    blob (a remote table's comes from its PS processes)."""
    out = {}
    for n in trainer.collection.names:
        spec = trainer.collection[n]
        blob = BK.unwrap(trainer.backends[n]).state_for_checkpoint(
            state.emb[n])
        out[n] = BK.extract_logical_rows(
            blob, spec, BK.parse_backend_name(spec.backend)[0])
    return out


def _same_rows(ta, sa, tb, sb):
    ra, rb = _rows(ta, sa), _rows(tb, sb)
    for n in ra:
        for x, y in zip(ra[n], rb[n]):
            np.testing.assert_array_equal(x, y, err_msg=n)


def _same_dense(sa, sb):
    for x, y in zip(tree_leaves(sa.dense), tree_leaves(sb.dense)):
        assert torch.equal(x, y)


def _run(trainer, batches, endpoints=None, lossy=None, **kw):
    if endpoints is not None:
        connect_remote_backends(trainer, endpoints, lossy=lossy, **kw)
    state = trainer.init(0, batches[0])
    losses = []
    for i, b in enumerate(batches):
        how = "step" if i % 2 == 0 else "decomposed_step"
        state, m = getattr(trainer, how)(state, b)
        losses.append(float(m["loss"]))
    return state, losses


# ---------------------------------------------------------------------------
# bit-exactness: remote == in-process, per mode x backend x shard count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("mode", ["sync", "hybrid", "async"])
@pytest.mark.parametrize("backend,cache", [("dense", None),
                                           ("host_lru", 48)])
def test_remote_training_bit_exact(servers, backend, cache, mode, k):
    """4 steps over k PS endpoints against the in-process trainer of the
    same geometry (the plain backend at k = 1, the router at k > 1)."""
    bs = _batches(4)
    t_ref = _trainer(backend, cache, mode, shards=k)
    ref, l_ref = _run(t_ref, bs)
    t = _trainer(backend, cache, mode)
    st, losses = _run(t, bs, endpoints=_endpoints(servers(k)))
    want = RemoteBackend if k == 1 else RemoteShardedBackend
    assert all(type(b) is want for b in t.backends.values())
    assert losses == l_ref
    _same_dense(st, ref)
    _same_rows(t, st, t_ref, ref)


def test_connect_some_tables_leaves_the_others_in_process(servers):
    """``connect_remote_backends(tables=...)`` points only the named
    tables at PS members: one table on one endpoint, another on two, the
    rest in process, 4 steps bit for bit with the in-process trainer."""
    bs = _batches(4)
    t_ref = _trainer()
    ref, l_ref = _run(t_ref, bs)
    t = _trainer()
    names = list(t.collection)
    connect_remote_backends(t, _endpoints(servers(1)), tables=names[:1])
    connect_remote_backends(t, _endpoints(servers(2)), tables=names[1:2])
    assert type(t.backends[names[0]]) is RemoteBackend
    assert type(t.backends[names[1]]) is RemoteShardedBackend
    assert not any(t.backends[n].remote for n in names[2:])
    st, losses = _run(t, bs)
    assert losses == l_ref
    _same_dense(st, ref)
    _same_rows(t, st, t_ref, ref)


@pytest.mark.parametrize("backend,cache", [("dense", None),
                                           ("host_lru", 48)])
def test_remote_occurrence_width_bit_exact(servers, backend, cache):
    """Tables at occurrence width (``batch_dedup=False``): the remote put
    ships the occurrence gradients and the PS groups them, as the
    in-process put does."""
    bs = _batches(4)
    t_ref = _trainer(backend, cache, batch_dedup=False)
    ref, l_ref = _run(t_ref, bs)
    t = _trainer(backend, cache, batch_dedup=False)
    st, losses = _run(t, bs, endpoints=_endpoints(servers(1)))
    assert losses == l_ref
    _same_rows(t, st, t_ref, ref)


@pytest.mark.parametrize("mode", ["sync", "hybrid"])
def test_remote_lossy_single_endpoint_matches_compressed_wire(servers,
                                                              mode):
    bs = _batches(4)
    t0 = _trainer("dense+compressed", mode=mode)
    s0, l0 = _run(t0, bs)
    t1 = _trainer("dense+compressed", mode=mode)  # suffix selects lossy
    (ep,) = _endpoints(servers(1))
    s1, l1 = _run(t1, bs, endpoints=[ep])
    assert all(isinstance(b, RemoteBackend) and b.lossy
               for b in t1.backends.values())
    assert l1 == l0
    _same_dense(s1, s0)
    _same_rows(t1, s1, t0, s0)
    # and the lossy wire differs from the raw one (it really compressed)
    t2 = _trainer("dense", mode=mode)
    _, l2 = _run(t2, bs, endpoints=_endpoints(servers(1)))
    assert l2 != l1


def test_remote_lossy_sharded_trains_against_itself(servers):
    """Lossy k = 2 compresses each shard's rows on its own (block
    boundaries differ from the in-process wire's): two runs agree with
    each other bit for bit, and stay near the raw wire."""
    bs = _batches(4)
    runs = []
    for lossy in (True, True, False):
        t = _trainer("dense")
        st, losses = _run(t, bs, endpoints=_endpoints(servers(2)),
                          lossy=lossy)
        runs.append((t, st, losses))
    (ta, sa, la), (tb, sb, lb), (tr, sr, lr) = runs
    assert la == lb
    _same_rows(ta, sa, tb, sb)
    np.testing.assert_allclose(la, lr, rtol=1e-2)
    assert la != lr


def test_remote_lossy_sharded_occurrence_width_keeps_every_id(servers):
    """Lossy k = 2 at occurrence width (``batch_dedup=False``), host_lru
    with 1,024 slots a shard and batches of ~1,800 distinct ids a table:
    the put groups its occurrences over the router's whole id space, so
    no shard's rows are dropped. Against the in-process
    ``host_lru+compressed`` router at k = 2, which compresses at the
    router: losses rtol 1e-5, accumulators rtol 1e-5 / atol 1e-9, rows
    within lr 2^-11 sqrt(D) per applied put (an fp16 payload element
    rounds within 2^-11 of itself; the blocks differ; 2 puts applied)."""
    rows, cache, lr = 8192, 2048, 5e-2
    cfg = dataclasses.replace(CFG, emb_rows=F * rows)
    ds = CTRDataset("rps_occ", n_rows=F * rows, n_fields=F,
                    ids_per_field=3, n_dense=4, zipf_a=0.0)

    def trainer(shards):
        coll = adapters.ctr_collection(cfg, lr=lr,
                                       field_rows=ds.field_rows())
        coll = coll.with_backend("host_lru+compressed", cache)
        if shards != 1:
            coll = coll.with_shards(shards)
        ad = adapters.recsys_adapter(cfg, field_rows=ds.field_rows(),
                                     collection=coll)
        return PersiaTrainer(ad, TrainMode.hybrid(2),
                             OptConfig(kind="adam", lr=5e-3),
                             batch_dedup=False, device="cpu")

    it = ds.sampler(1024, seed=0)
    bs = [next(it) for _ in range(4)]
    ids = np.asarray(bs[0]["ids"])[:, 0].reshape(-1)
    assert np.unique(ids[ids >= 0]).size > 1024
    t_ref = trainer(2)
    ref, l_ref = _run(t_ref, bs)
    t = trainer(1)
    st, losses = _run(t, bs, endpoints=_endpoints(servers(2)))
    b = t.backends["field_00"]
    assert isinstance(b, RemoteShardedBackend) and b.lossy
    # the grouping keeps all 2,048 device ids of the two shards
    flat = torch.arange(b.dev_rows(), dtype=torch.int32).repeat(2)
    got, _, unique = b.put_sums(flat, torch.ones(flat.numel(), D))
    assert unique and sorted(got[got >= 0].tolist()) == list(
        range(b.dev_rows()))
    np.testing.assert_allclose(losses, l_ref, rtol=1e-5)
    ra, rb = _rows(t, st), _rows(t_ref, ref)
    for n in ra:
        _close(ra[n][0], rb[n][0], 0, 2 * lr * 2.0 ** -11 * np.sqrt(D), n)
        _close(ra[n][1], rb[n][1], 1e-5, 1e-9, n)


def test_put_is_applied_before_the_next_prepare_and_lookup(servers):
    """A put still buffered in the window (unacked, unflushed) is applied
    by the PS before a later prepare or lookup of ANY table on its
    endpoint: the coalesced frame and the connection's serial execution
    order them."""
    bs = _batches(2)
    t = _trainer("host_lru", 48, tau=3)
    connect_remote_backends(t, _endpoints(servers(1)))
    s = t.init(0, bs[0])
    s, _ = t.step(s, bs[0])
    bk = t.backends["field_00"]
    assert bk.put_window == 3 and len(bk._acks) == 1
    assert bk._client._coal, "the put should still be buffered"
    # in process, from the same start: the rows a lookup reads after it
    t_ref = _trainer("host_lru", 48, tau=3)
    r = t_ref.init(0, bs[0])
    r, _ = t_ref.step(r, bs[0])
    ids = {n: np.arange(RPF).reshape(8, 8) for n in t.collection.names}
    got, _ = BK.read_pooled_all(t.backends, s.emb, ids, "cpu")
    want, _ = BK.read_pooled_all(t_ref.backends, r.emb, ids, "cpu")
    for n in got:
        assert torch.equal(got[n], want[n])
    s, _, _ = t._prepare(s, bs[1])
    assert not bk._client._coal


def test_remote_serving_reads_match_in_process(servers):
    """read_pooled_all and the occurrence reads over remote tables (one
    endpoint, raw and lossy; the router over 2) equal the in-process
    reads bit for bit, with the same gauges."""
    bs = _batches(3)
    ids = {n: np.random.default_rng(3).integers(-1, RPF, (16, 4))
           for n in ("field_00", "field_01")}
    for backend, k, lossy in (("dense", 1, None), ("host_lru", 1, None),
                              ("dense+compressed", 1, None),
                              ("host_lru", 2, None)):
        cache = 48 if backend == "host_lru" else None
        t_ref = _trainer(backend, cache, shards=k)
        ref, _ = _run(t_ref, bs)
        t = _trainer(backend, cache)
        st, _ = _run(t, bs, endpoints=_endpoints(servers(k)), lossy=lossy)
        got, gi = BK.read_pooled_all(t.backends, st.emb, ids, "cpu")
        want, wi = BK.read_pooled_all(t_ref.backends, ref.emb, ids, "cpu")
        for n in got:
            assert torch.equal(got[n], want[n]), (backend, k, n)
        assert gi == wi
        batch = {"ids": np.stack([ids[n] for n in sorted(ids)], 1),
                 "dense": np.zeros((16, 4), np.float32)}
        occ, occ_ref = t.lookup(st, batch), t_ref.lookup(ref, batch)
        for n in occ:
            assert torch.equal(occ[n], occ_ref[n]), (backend, k, n)


# ---------------------------------------------------------------------------
# serve-while-train over the wire (port of tests/test_online_loop.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,n_ps", [("dense", 1), ("dense", 2),
                                          ("host_lru", 2)])
def test_remote_serve_while_train_is_serial(servers, backend, n_ps):
    """Port of ``tests/test_online_loop.py::
    test_remote_serve_while_train_is_serial``: a reader thread reading the
    remote serve path under the cell's lock during remote sync training
    observes, at every published step, bit for bit the pooled rows an
    uninterrupted in-process run of the same geometry (the plain backend
    at k = 1, the router at k = 2) reads at that step, and the final rows
    and dense parameters equal that run's."""
    steps = 4
    bs = _batches(steps + 1)
    probe = bs[0]
    cache = 40 if backend == "host_lru" else None

    def acts(trainer, state):
        return {n: a.numpy().copy()
                for n, a in trainer.serve_lookup(state, probe)[0].items()}

    t_ref = _trainer(backend, cache, "sync", shards=n_ps)
    s = t_ref.init(0, bs[0])
    ref = {0: acts(t_ref, s)}
    for t in range(steps):
        s, _ = t_ref.decomposed_step(s, bs[t + 1])
        ref[t + 1] = acts(t_ref, s)

    trainer = _trainer(backend, cache, "sync")
    connect_remote_backends(trainer, _endpoints(servers(n_ps)))
    state = trainer.init(0, bs[0])
    cell = StateCell(state, 0)
    errors, seen = [], set()
    done = threading.Event()

    def reader():
        while not done.is_set():
            with cell.lock:
                snap, t = cell.snapshot()
                got = acts(trainer, snap)
            for n, a in got.items():
                if not np.array_equal(a, ref[t][n]):
                    errors.append((t, n))
            seen.add(t)

    def read_at(t):
        until = time.monotonic() + 30
        while t not in seen and time.monotonic() < until:
            time.sleep(1e-3)

    th = threading.Thread(target=reader)
    th.start()
    st = state
    for t in range(steps):
        read_at(t)
        with cell.lock:
            st, _ = trainer.decomposed_step(st, bs[t + 1])
            cell.publish(st, t + 1)
    read_at(steps)
    done.set()
    th.join(timeout=60)
    assert not th.is_alive()
    assert not errors, f"remote reader saw non-serial rows at {errors[:5]}"
    assert seen == set(range(steps + 1))
    with cell.lock:
        final = acts(trainer, st)
    for n, a in final.items():
        np.testing.assert_array_equal(a, ref[steps][n])
    _same_rows(trainer, st, t_ref, s)
    _same_dense(st, s)


# ---------------------------------------------------------------------------
# the pipelined trainer over remote tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_remote_pipelined_inflight1_bit_exact(servers, k):
    bs = _batches(5)
    t0 = _trainer("host_lru", 48)
    s0 = t0.init(0, bs[0])
    for b in bs:
        s0, m0 = t0.step(s0, b)
    t1 = _trainer("host_lru", 48)
    connect_remote_backends(t1, _endpoints(servers(k)))
    s1 = t1.init(0, bs[0])
    s1, ms1 = PipelinedTrainer(t1, max_inflight=1).run(s1, iter(bs))
    assert float(ms1[-1]["loss"]) == float(m0["loss"])
    _same_rows(t1, s1, t0, s0)


def test_remote_prefetch_pipeline_matches_inprocess(servers):
    """prefetch=2 over remote host_lru tables: the look-ahead fault-ins
    ride the coalesced wire ahead of the inflight window (up to 2 remote
    prepares in flight) and the result stays bit-exact with the
    identically-configured in-process engine."""
    bs = _batches(6)
    t0 = _trainer("host_lru", RPF)          # eviction-free cache
    s0 = t0.init(0, bs[0])
    s0, ms0 = PipelinedTrainer(t0, max_inflight=1, prefetch=2).run(
        s0, iter(bs))
    t1 = _trainer("host_lru", RPF)
    connect_remote_backends(t1, _endpoints(servers(2)))
    s1 = t1.init(0, bs[0])
    e1 = PipelinedTrainer(t1, max_inflight=1, prefetch=2)
    s1, ms1 = e1.run(s1, iter(bs))
    assert [float(m["loss"]) for m in ms1] == [float(m["loss"])
                                               for m in ms0]
    assert e1.pipeline_metrics()["pipeline/prefetch/items"] == float(len(bs))
    _same_rows(t1, s1, t0, s0)


def test_remote_deep_pipeline_keeps_order_and_pins(servers):
    """max_inflight=3 with a look-ahead over remote host_lru tables: every
    put applied in order, the put window never past tau, every remote pin
    released (the PS slot map holds no pin after the run)."""
    bs = _batches(8)
    t = _trainer("host_lru", RPF, tau=2)
    srvs = servers(2)
    connect_remote_backends(t, _endpoints(srvs))
    s = t.init(0, bs[0])
    e = PipelinedTrainer(t, max_inflight=3, prefetch=1)
    s, ms = e.run(s, iter(bs))
    assert e.applied_order == list(range(len(bs)))
    assert max(e.max_outstanding.values()) <= 2
    assert all(np.isfinite(float(m["loss"])) for m in ms)
    for n, bk in t.backends.items():
        bk.sync(s.emb[n])
    for srv in srvs:
        for ent in srv._tables.values():
            assert not ent["backend"]._pin_count.any()


# ---------------------------------------------------------------------------
# checkpoints: remote <-> in-process, and a JAX checkpoint into the remote
# ---------------------------------------------------------------------------

def test_remote_checkpoint_restores_in_process_and_back(servers, tmp_path):
    bs = _batches(3)
    t0 = _trainer("dense")
    s0, _ = _run(t0, bs, endpoints=_endpoints(servers(2)))
    t0.save(str(tmp_path / "remote_ck"), s0)
    assert checkpoint_shard_layout(str(tmp_path / "remote_ck")) == \
        {n: 2 for n in t0.collection.names}
    # a shard-tagged remote checkpoint restores into an IN-PROCESS router
    t1 = _trainer("dense", shards=2)
    s1 = t1.restore(str(tmp_path / "remote_ck"))
    # the same run in process
    t2 = _trainer("dense", shards=2)
    s2, _ = _run(t2, bs)
    _same_rows(t1, s1, t2, s2)
    _same_dense(s1, s2)
    # the restored in-process trainer steps on (its queues restart empty)
    s1, m1 = t1.step(s1, bs[0])
    assert np.isfinite(float(m1["loss"]))
    # ... and an in-process checkpoint restores into a REMOTE trainer, at
    # another member count (a 2 -> 3 reshard into the PS processes)
    t2.save(str(tmp_path / "local_ck"), s2)
    for k in (2, 3):
        t3 = _trainer("dense")
        connect_remote_backends(t3, _endpoints(servers(k)))
        t3.init(0, bs[0])
        s3 = t3.restore(str(tmp_path / "local_ck"))
        _same_rows(t3, s3, t2, s2)
        assert all(b.last_restore_resharded == (k != 2)
                   for b in t3.backends.values())
        s3, m3 = t3.step(s3, bs[1])
        assert np.isfinite(float(m3["loss"]))


def _jax_pair(shards):
    jcfg = JConfig(**dataclasses.asdict(CFG))
    jds = jctr.CTRDataset(**dataclasses.asdict(DS))
    jcoll = jadapters.ctr_collection(jcfg, lr=5e-2,
                                     field_rows=jds.field_rows())
    if shards > 1:
        jcoll = jcoll.with_shards(shards)
    return jhybrid.PersiaTrainer(
        jadapters.recsys_adapter(jcfg, field_rows=jds.field_rows(),
                                 collection=jcoll),
        jhybrid.TrainMode.hybrid(2), jopt.OptConfig(kind="adam", lr=5e-3))


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_jax_sharded_checkpoint_restores_into_the_remote_trainer(
        servers, tmp_path):
    """A JAX 2-shard checkpoint restores into the port's remote trainer
    over 2 PS processes row for row, and training goes on."""
    bs = _batches(3, seed=2)
    jt = _jax_pair(2)
    js = jt.init(jax.random.PRNGKey(1), _jnp(bs[0]))
    for b in bs:
        js, _ = jt.step(js, _jnp(b))
    jt.save(str(tmp_path / "j"), js)
    t = _trainer("dense")
    connect_remote_backends(t, _endpoints(servers(2)))
    t.init(0, bs[0])
    s = t.restore(str(tmp_path / "j"))
    got = _rows(t, s)
    from repro.core import backend as jbackend
    for n in t.collection.names:
        jblob = jbackend.unwrap(jt.backends[n]).state_for_checkpoint(
            js.emb[n])
        want = jbackend.extract_logical_rows(jblob, jt.collection[n],
                                             "dense")
        for a, b in zip(got[n], want):
            np.testing.assert_array_equal(a, b)
    s, m = t.step(s, bs[0])
    assert np.isfinite(float(m["loss"]))


def test_remote_slice_against_jax_in_process():
    """The slice against JAX: the port's remote trainer over 2 PS
    processes (threads here) and the port's in-process trainer, both from
    one JAX-exported state, 4 hybrid(2) steps, against the JAX package's
    IN-PROCESS trainer. The two port trainers agree bit for bit (losses,
    dense parameters, rows, accumulators). Against JAX the tables and
    accumulators hold rtol 1e-5 / atol 1e-6 and the losses and dense side
    the FFNN class (rtol 1e-5 / atol 1e-6), the classes of the port's
    in-process trainer against JAX (``tests/test_torch_sharded.py``): the
    JAX package's own remote-against-in-process class (rtol 1e-6 / atol
    1e-8, <= 7.45e-9) is too tight for any port trainer here, because
    torch's FFNN rounds the activation gradients differently from XLA's
    (the rows part by up to 2.98e-8, 2.85e-6 relative, in 1 of 512
    elements after 4 steps), and the remote path inherits the in-process
    path's numbers exactly."""
    srvs = [PSServer(device="cpu").start() for _ in range(2)]
    try:
        bs = _batches(4, seed=5)
        jt = _jax_pair(1)
        js = jt.init(jax.random.PRNGKey(0), _jnp(bs[0]))
        ports = []
        for endpoints in (None, _endpoints(srvs)):
            t = _trainer("dense")
            queues = _to_np(js.emb_queue)
            if endpoints is not None:
                # the JAX state's queues are empty and of one shard: the
                # 2-shard remote tables start theirs empty (queue_init)
                connect_remote_backends(t, endpoints)
                queues = None
                fresh = t.init(0, bs[0]).emb_queue
            ts = convert.state_from_numpy(
                t, _to_np(js.dense), _to_np(js.emb), opt=_to_np(js.opt),
                emb_queue=queues, step=int(js.step))
            if endpoints is not None:
                ts = ts.replace(emb_queue=fresh)
            ports.append([t, ts, []])
        for b in bs:
            js, jm = jt.decomposed_step(js, _jnp(b))
            for p in ports:
                p[1], tm = p[0].step(p[1], b)
                p[2].append(float(tm["loss"]))
                _close(float(tm["loss"]), float(jm["loss"]), 1e-5, 0,
                       "loss")
        (t0, s0, l0), (t1, s1, l1) = ports
        assert l0 == l1
        _same_dense(s0, s1)
        _same_rows(t0, s0, t1, s1)
        for g, w in zip(tree_leaves(s1.dense), jax.tree.leaves(js.dense)):
            _close(g.numpy(), np.asarray(w), 1e-5, 1e-6, "dense")
        from repro.core import backend as jbackend
        got = _rows(t1, s1)
        for n in t1.collection.names:
            jblob = jbackend.unwrap(jt.backends[n]).state_for_checkpoint(
                js.emb[n])
            want = jbackend.extract_logical_rows(jblob, jt.collection[n],
                                                 "dense")
            _close(got[n][0], want[0], 1e-5, 1e-6, f"{n} rows")
            _close(got[n][1], want[1], 1e-5, 1e-6, f"{n} acc")
        for b in t1.backends.values():
            b.close()
    finally:
        for s in srvs:
            s.stop()


# ---------------------------------------------------------------------------
# the wire path: windows, coalescing, the blocking baseline
# ---------------------------------------------------------------------------

def _frames_sent(trainer):
    seen = {}
    for bk in trainer.backends.values():
        for sub in getattr(bk, "shard_backends", None) or [bk]:
            seen[id(sub._client)] = sub._client
    return sum(c.frames_sent for c in seen.values())


def test_put_window_derives_from_staleness(servers):
    spec = EmbeddingSpec(rows=64, dim=8)
    (srv,) = servers(1)
    ep = ("127.0.0.1", srv.port)
    subs = [RemoteBackend(dataclasses.replace(spec, staleness=tau), ep,
                          table=name, device="cpu", **kw)
            for name, tau, kw in (("a", 0, {}), ("b", 3, {}), ("c", 100, {}),
                                  ("d", 100, {"put_window": 2}),
                                  ("e", 3, {"pipelined": False}))]
    try:
        # sync: 1; hybrid: tau; deep tau: capped; override wins; the
        # blocking baseline is always one synchronous RTT per op
        assert [b.put_window for b in subs] == [1, 3, 8, 2, 1]
    finally:
        for b in subs:
            b.close()


def test_blocking_baseline_bit_exact_and_coalescing_cuts_frames(servers):
    """The pipelined wire path changes WHEN bytes move, never what they
    say: pipelined=False and the coalesced windowed path train
    identically, while the pipelined path ships fewer frames."""
    bs = _batches(4)
    out = []
    for pipelined in (False, True):
        t = _trainer("host_lru", 48)
        connect_remote_backends(t, _endpoints(servers(2)),
                                pipelined=pipelined)
        s = t.init(0, bs[0])
        f0 = _frames_sent(t)
        for b in bs:
            s, m = t.step(s, b)
        for n, st in s.emb.items():
            t.backends[n].sync(st)
        out.append((t, s, float(m["loss"]), _frames_sent(t) - f0))
    (t0, s0, l0, f0), (t1, s1, l1, f1) = out
    assert l1 == l0
    _same_rows(t1, s1, t0, s0)
    assert f1 <= 0.6 * f0, (f1, f0)


# ---------------------------------------------------------------------------
# validation / failure classification / the server's device
# ---------------------------------------------------------------------------

def test_remote_backend_validation(servers):
    (srv,) = servers(1)
    spec = EmbeddingSpec(rows=64, dim=8)
    ep = ("127.0.0.1", srv.port)
    with pytest.raises(ValueError, match="lossy"):
        RemoteBackend(dataclasses.replace(spec, backend="dense+compressed"),
                      ep)
    with pytest.raises(ValueError, match="RemoteShardedBackend"):
        RemoteBackend(dataclasses.replace(spec, emb_shards=2), ep)
    t = _trainer("dense", shards=3)
    with pytest.raises(ValueError, match="emb_shards=3"):
        connect_remote_backends(t, _endpoints([srv]))
    # the PS draws with the trainer's generator: one device type
    b = RemoteBackend(spec, ep, table="g", device="cpu")
    with pytest.raises(Exception, match="one device type"):
        b._call("init", _mutating=True, gen_state=torch.Generator()
                .get_state().numpy(), gen_device="cuda")
    b.close()
    # a queue of another geometry (one shard's, on a 2-shard table)
    (srv2,) = servers(1)
    t = _trainer("dense")
    connect_remote_backends(t, _endpoints([srv, srv2]))
    s = t.init(0, _batches(1)[0])
    flat = _trainer("dense").init(0, _batches(1)[0]).emb_queue
    with pytest.raises(ValueError, match="geometry"):
        t.step(s.replace(emb_queue=flat), _batches(1)[0])


def test_unavailable_is_named_and_classified(free_port):
    spec = EmbeddingSpec(rows=64, dim=8)
    with pytest.raises(PSUnavailableError) as ei:
        RemoteBackend(spec, ("127.0.0.1", free_port()), timeout=0.3,
                      retries=1, backoff=0.01)
    assert is_ps_failure(ei.value)
    wrapped = RuntimeError(f"callback failed: {ei.value!r}")
    assert is_ps_failure(wrapped)
    from repro_torch.core.pipeline import PipelineStageError
    assert is_ps_failure(PipelineStageError("put", 3, ei.value))
    assert not is_ps_failure(ValueError("unrelated"))


def test_ps_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        PSServer()
    srv = PSServer(device="cpu")
    assert srv.device == torch.device("cpu")
    srv.rpc._listener.close()


def test_ps_metrics_report_apply_launches(servers):
    """The metrics op: a table's puts and op seconds, and the PS
    process's kernel launch counts."""
    bs = _batches(2)
    t = _trainer("dense", tau=0, mode="sync")
    connect_remote_backends(t, _endpoints(servers(1)))
    s = t.init(0, bs[0])
    for b in bs:
        s, _ = t.step(s, b)
    bk = t.backends["field_00"]
    bk.sync(s.emb["field_00"])
    rep = bk.remote_metrics()
    assert rep["puts"] == 2 and rep["seconds"]["put"] > 0
    assert "fused_backward" in rep["launches"]


# ---------------------------------------------------------------------------
# heartbeats + elastic membership
# ---------------------------------------------------------------------------

def test_heartbeat_detects_killed_server(servers):
    srvs = servers(2)
    mon = HeartbeatMonitor(_endpoints(srvs), interval=0.05,
                           miss_threshold=2, ping_timeout=0.3)
    assert mon.probe_once() == set()
    srvs[1].kill()
    dead = set()
    for _ in range(4):
        dead = mon.probe_once()
    assert dead == {("127.0.0.1", srvs[1].port)}
    assert any(e["kind"] == "dead" for e in mon.events)
    mon.start()
    mon.stop()


def _cluster(servers, tmp_path, n, backend="host_lru", cache=48, tau=2,
             recoveries=2):
    srvs = servers(n, spool_root=tmp_path)
    members = [PSMember("127.0.0.1", s.port, spool_dir=s.spool_dir)
               for s in srvs]
    t = _trainer(backend, cache, tau=tau)
    cluster = ElasticPSCluster(t, members, max_recoveries=recoveries,
                               ping_timeout=0.5)
    cluster.connect(timeout=1.0, retries=1, backoff=0.05)
    return srvs, t, cluster


def test_elastic_kill_reshard_join(servers, tmp_path):
    srvs, t, cluster = _cluster(servers, tmp_path, 3)
    bs = _batches(6)
    state = t.init(0, bs[0])
    for b in bs[:2]:
        state, _ = cluster.step(state, b)
    # the spool holds every APPLIED put: the kill loses at most in-flight
    assert read_spool(srvs[0].spool_dir, t.collection.names[0]) is not None
    srvs[1].kill()
    for b in bs[2:4]:
        state, m = cluster.step(state, b)
    assert len(cluster.members) == 2
    resh = [e for e in cluster.events if e["kind"] == "reshard"]
    assert resh and resh[0]["dead"] == [1]
    assert all(v == 0 for v in resh[0]["lost_rows"].values())
    assert np.isfinite(float(m["loss"]))
    # elastic JOIN: a fresh member grows the shard set back to 3
    new = servers(1, spool_root=tmp_path)[0]
    state = cluster.join(PSMember("127.0.0.1", new.port,
                                  spool_dir=new.spool_dir), state)
    assert len(cluster.members) == 3
    assert all(b.n_shards == 3 for b in t.backends.values())
    for b in bs[4:]:
        state, m = cluster.step(state, b)
    assert np.isfinite(float(m["loss"]))
    cluster.close()


def test_midwindow_shard_kill_reshards_without_losing_acked_puts(
        servers, tmp_path):
    """Kill a shard with windowed puts still in flight (hybrid tau=3 ->
    put_window=3, acks outstanding across steps): recovery discards only
    the unacked window and reshards from the spools — every ACKED put was
    spooled before its ack, so no rows are lost."""
    srvs, t, cluster = _cluster(servers, tmp_path, 3, tau=3)
    bs = _batches(6)
    state = t.init(0, bs[0])
    for b in bs[:3]:
        state, _ = cluster.step(state, b)
    bk0 = t.backends[t.collection.names[0]]
    assert all(sub.put_window == 3 for sub in bk0.shard_backends)
    assert any(len(sub._acks) > 0 for sub in bk0.shard_backends)
    srvs[1].kill()
    for b in bs[3:5]:
        state, m = cluster.step(state, b)
    resh = [e for e in cluster.events if e["kind"] == "reshard"]
    assert resh and resh[0]["dead"] == [1]
    assert all(v == 0 for v in resh[0]["lost_rows"].values())
    assert len(cluster.members) == 2
    assert np.isfinite(float(m["loss"]))
    for name in t.collection.names:
        for sub in t.backends[name].shard_backends:
            assert sub.endpoint in [m_.endpoint for m_ in cluster.members]
    cluster.close()


def test_elastic_all_dead_raises_named_error(servers, tmp_path):
    srvs, t, cluster = _cluster(servers, tmp_path, 2, backend="dense",
                                cache=None, recoveries=1)
    bs = _batches(2)
    state = t.init(0, bs[0])
    state, _ = cluster.step(state, bs[0])
    for s in srvs:
        s.kill()
    with pytest.raises(ClusterDeadError):
        cluster.step(state, bs[1])
    cluster.close()


def test_elastic_step_restarts_from_the_dense_copy(servers, tmp_path):
    """A step that fails after its in-place dense update (its put raises)
    is retried from the copy taken before it: the dense parameters equal
    those of a run without the failure bit for bit (they moved one step,
    not two)."""
    import unittest.mock as mock
    bs = _batches(2)
    runs = []
    for fail in (False, True):
        _, t, cluster = _cluster(servers, tmp_path / str(fail), 2,
                                 backend="dense", cache=None)
        state = t.init(0, bs[0])
        state, _ = cluster.step(state, bs[0])
        calls = {"n": 0}
        real = BK.put_all

        def flaky(*a, **kw):
            calls["n"] += 1
            if fail and calls["n"] == 1:
                raise PSUnavailableError("injected")
            return real(*a, **kw)

        with mock.patch.object(BK, "put_all", flaky):
            state, m = cluster.step(state, bs[1])
        assert calls["n"] == (2 if fail else 1)
        assert [e["kind"] for e in cluster.events] == \
            (["transient"] if fail else [])
        runs.append((state, float(m["loss"])))
        cluster.close()
    (a, la), (b, lb) = runs
    assert la == lb and a.step == b.step == 2
    _same_dense(a, b)
