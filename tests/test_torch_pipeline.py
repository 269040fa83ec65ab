"""The port's pipelined trainer (repro_torch.core.pipeline) and its slice —
the collection facade, CheckpointManager, the CTR launcher, the tuned-host
profile and the thread-safe launch counters — on the CPU, against the
port's own serial trainer and against the JAX package.

Each port of a test of ``tests/test_pipeline.py`` and of the prefetch
tests of ``tests/test_cache_tiers.py`` keeps that test's name and sizes (3
fields x 128 rows x dim 8) and is bit-exact where the JAX test is.

Tolerance classes:
* bit-exact: the pipelined trainer against the port's serial trainer
  (the same ops in the same order), checkpoints, launch counts, the
  collection's integer and queue logic and its puts (the same fp32 row
  updates in the same order);
* allclose, the FFNN's class (``tests/test_torch_train.py``): the port's
  pipeline against JAX's, from the JAX-exported start — losses rtol 1e-5
  per step; after 4 steps tables, dense params and queued grads rtol 1e-5
  atol 1e-6, accumulators rtol 1e-5 atol 1e-9, Adam m rtol 1e-4 atol 1e-8
  and v rtol 1e-4 atol 1e-12; behind the compressed wire the lossy class
  of ``_check_wire_states`` (an fp16 step of a payload reaches the tables,
  the accumulators and, through the next steps' lookups, the dense side).
"""
import dataclasses
import os
import sys
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
from repro.core.collection import EmbeddingCollection as JCollection
from repro.core.embedding_ps import EmbeddingSpec as JSpec
from repro.core.pipeline import PipelinedTrainer as JPipelinedTrainer
from repro.data import ctr as jctr
from repro.optim import optimizers as jopt

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapters
from repro_torch.core import backend as BK
from repro_torch.core.backend import create_backend
from repro_torch.core.collection import EmbeddingCollection
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.core.pipeline import (PipelinedTrainer, PipelineStageError,
                                       STAGES)
from repro_torch.data.ctr import CTRDataset
from repro_torch.kernels import ops
from repro_torch.launch import hostenv
from repro_torch.launch import train as launch_train
from repro_torch.launch.shards import apply_backend_choice
from repro_torch.optim.optimizers import OptConfig
from repro_torch.utils import tree_leaves

from test_torch_host_lru import _blobs, _check_tiers
from test_torch_train import _check_states, _close, _to_np

F, RPF, D = 3, 128, 8      # fields x rows-per-field x dim

CFG = ModelConfig(name="pl", arch_type="recsys", n_id_fields=F,
                  ids_per_field=3, emb_dim=D, emb_rows=F * RPF,
                  n_dense_features=4, mlp_dims=(16,), n_tasks=1)
DS = CTRDataset("pl", n_rows=F * RPF, n_fields=F, ids_per_field=3, n_dense=4)


def _batches(n, batch=32, seed=0):
    it = DS.sampler(batch, seed=seed)
    return [next(it) for _ in range(n)]


def _trainer(backend="dense", cache_rows=None, mode=None):
    coll = adapters.ctr_collection(CFG, lr=5e-2, field_rows=DS.field_rows())
    if backend != "dense":
        coll = coll.with_backend(backend, cache_rows)
    ad = adapters.recsys_adapter(CFG, field_rows=DS.field_rows(),
                                 collection=coll)
    return PersiaTrainer(ad, mode or TrainMode.hybrid(3),
                         OptConfig(kind="adam", lr=5e-3), device="cpu")


def _assert_states_equal(sa, sb):
    """Bit for bit: every table, accumulator and queue, the dense params,
    the optimizer's moments and the step."""
    for n in sa.emb:
        for k in sa.emb[n]:
            assert torch.equal(sa.emb[n][k], sb.emb[n][k]), (n, k)
        qa, qb = sa.emb_queue[n], sb.emb_queue[n]
        assert (qa is None) == (qb is None)
        if qa is not None:
            for k, v in qa.items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(v, qb[k]), (n, k)
                else:
                    assert v == qb[k], (n, k)
    for a, b in zip(tree_leaves(sa.dense), tree_leaves(sb.dense)):
        assert torch.equal(a, b)
    for k in ("m", "v"):
        for a, b in zip(tree_leaves(sa.opt[k]), tree_leaves(sb.opt[k])):
            assert torch.equal(a, b)
    assert sa.step == sb.step


def _losses(ms):
    return [float(m["loss"]) for m in ms]


# ---------------------------------------------------------------------------
# determinism: max_inflight=1 == serial decomposed_step, bit for bit
# ---------------------------------------------------------------------------

MODES = {"sync": TrainMode.sync(), "hybrid": TrainMode.hybrid(3),
         "async": TrainMode.async_(3, 3)}


@pytest.mark.timeout(240)
@pytest.mark.parametrize("backend,cache", [("dense", None),
                                           ("host_lru", RPF),
                                           ("host_lru", 100),
                                           ("dense+compressed", None)],
                         ids=["dense", "host_lru", "host_lru_evicts",
                              "dense+compressed"])
@pytest.mark.parametrize("mode", list(MODES))
def test_inflight1_bit_exact_with_serial(backend, cache, mode):
    """The determinism contract: one permit pins the exact serial dispatch
    order, so 25 pipelined steps equal 25 serial steps bit for bit —
    dense params, every table, adagrad accs, queues, losses (and a host_lru
    table's slot map and host rows, evicting or not)."""
    batches = _batches(25)
    ta = _trainer(backend, cache, MODES[mode])
    sa, ms_a = ta.run(ta.init(0, batches[0]), batches)
    tb = _trainer(backend, cache, MODES[mode])
    engine = PipelinedTrainer(tb, max_inflight=1)
    sb, ms_b = engine.run(tb.init(0, batches[0]), batches)
    assert len(ms_a) == len(ms_b) == 25
    assert _losses(ms_a) == _losses(ms_b)
    _assert_states_equal(sa, sb)
    for n in ta.backends:
        a, b = BK.unwrap(ta.backends[n]), BK.unwrap(tb.backends[n])
        if isinstance(a, BK.HostLRUBackend):
            assert np.array_equal(a._id_for_slot, b._id_for_slot)
            assert np.array_equal(a.store.vectors, b.store.vectors)
            assert (a.writebacks > 0) == (cache < RPF)


@pytest.mark.timeout(240)
def test_deep_pipeline_trains_and_preserves_order():
    """max_inflight > 1: results arrive complete and in batch order, puts
    apply FIFO per table, and the run still learns (loss finite)."""
    batches = _batches(20)
    tr = _trainer("host_lru", RPF)
    engine = PipelinedTrainer(tr, max_inflight=4)
    state = engine.init(0, batches[0])
    state, ms = engine.run(state, batches)
    assert len(ms) == 20
    assert engine.applied_order == list(range(20))     # no drop, no reorder
    assert all(np.isfinite(_losses(ms)))
    assert state.step == 20
    # the engine is reusable: a second run continues from the final state
    state, ms2 = engine.run(state, _batches(5, seed=7))
    assert len(ms2) == 5 and state.step == 25


# ---------------------------------------------------------------------------
# stress: random stage delays, staleness invariant, failure propagation
# ---------------------------------------------------------------------------

@pytest.mark.timeout(240)
@pytest.mark.parametrize("seed", [0, 1])
def test_stress_random_delays_hold_invariants(seed):
    """Seeded random per-stage sleeps skew every stage's relative speed;
    the bounded-staleness invariant (outstanding puts <= min(max_inflight,
    tau) per table) and order preservation must survive the skew, and with
    a window of 1 the delayed pipeline equals the serial run."""
    rng = np.random.default_rng(seed)
    delays = {(s, i): float(rng.uniform(0, 0.004))
              for s in STAGES for i in range(16)}

    def delay_fn(stage, idx):
        return delays.get((stage, idx), 0.0)

    batches = _batches(16)
    tau, inflight = 2, 3
    tr = _trainer("host_lru", RPF, TrainMode.hybrid(tau))
    engine = PipelinedTrainer(tr, max_inflight=inflight, delay_fn=delay_fn)
    state = engine.run(engine.init(0, batches[0]), batches)[0]
    assert engine.applied_order == list(range(16))
    for n, peak in engine.max_outstanding.items():
        assert 1 <= peak <= min(inflight, tau), (n, peak)
    assert state.step == 16
    tr1 = _trainer("host_lru", RPF, TrainMode.hybrid(tau))
    e1 = PipelinedTrainer(tr1, max_inflight=1, delay_fn=delay_fn)
    s1 = e1.run(e1.init(0, batches[0]), batches)[0]
    tr2 = _trainer("host_lru", RPF, TrainMode.hybrid(tau))
    s2, _ = tr2.run(tr2.init(0, batches[0]), batches)
    _assert_states_equal(s1, s2)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("stage", ["loader", "prepare", "lookup", "dense",
                                   "put"])
def test_stage_exception_surfaces_without_hanging(stage):
    """A failure in ANY stage must abort the whole pipeline and re-raise
    from run() promptly (stop-event-aware queue waits), naming the stage."""
    batches = _batches(12)

    def delay_fn(s, idx):
        if s == stage and idx == 4:
            raise RuntimeError(f"injected-{stage}")
        return 0.0

    tr = _trainer("dense")
    engine = PipelinedTrainer(tr, max_inflight=3, delay_fn=delay_fn)
    state = engine.init(0, batches[0])
    t0 = time.monotonic()
    with pytest.raises(PipelineStageError, match=stage) as ei:
        engine.run(state, batches)
    assert time.monotonic() - t0 < 60
    assert ei.value.stage == stage and ei.value.step == 4
    assert isinstance(ei.value.original, RuntimeError)


@pytest.mark.timeout(120)
def test_sync_tables_never_read_past_unapplied_put():
    """tau=0 forces the put window to 1 even with a deep pipeline: sync
    semantics admit no pipeline-induced staleness, so inflight=4 sync must
    stay bit-exact with the serial sync run."""
    batches = _batches(12)
    ta = _trainer("dense", mode=TrainMode.sync())
    sa, _ = ta.run(ta.init(0, batches[0]), batches)
    tb = _trainer("dense", mode=TrainMode.sync())
    engine = PipelinedTrainer(tb, max_inflight=4)
    assert all(engine.put_window(n) == 1 for n in tb.collection.names)
    sb, _ = engine.run(engine.init(0, batches[0]), batches)
    for n in engine.max_outstanding:
        assert engine.max_outstanding[n] == 1
    _assert_states_equal(sa, sb)


# ---------------------------------------------------------------------------
# metrics and guardrails
# ---------------------------------------------------------------------------

@pytest.mark.timeout(120)
def test_pipeline_metrics_schema_and_occupancy():
    batches = _batches(8)
    tr = _trainer("host_lru", RPF)
    engine = PipelinedTrainer(
        tr, max_inflight=3,
        delay_fn=lambda s, i: 0.003 if s == "prepare" else 0.0)
    engine.run(engine.init(0, batches[0]), batches)
    pm = engine.pipeline_metrics()
    for stage in STAGES:
        assert pm[f"pipeline/{stage}/busy_s"] >= 0.0
        assert 0.0 <= pm[f"pipeline/{stage}/occupancy"] <= 1.0 + 1e-6
        assert pm[f"pipeline/{stage}/items"] == 8.0
    for stage in ("prepare", "lookup", "dense", "put"):
        assert pm[f"pipeline/{stage}/queue_depth_max"] <= 3.0
    assert pm["pipeline/prepare/busy_s"] >= 8 * 0.003
    assert pm["pipeline/steps"] == 8.0 and pm["pipeline/steps_per_s"] > 0
    for n in tr.collection.names:
        assert pm[f"pipeline/outstanding_puts_max/{n}"] >= 1.0


def test_engine_rejects_bad_construction():
    with pytest.raises(TypeError, match="PersiaTrainer"):
        PipelinedTrainer(object())
    tr = _trainer()
    with pytest.raises(ValueError, match="max_inflight"):
        PipelinedTrainer(tr, max_inflight=0)
    # emb_shards passes through to the trainer: host_lru tables go over the
    # router, and a mistyped table name is refused
    lru = _trainer("host_lru", RPF)
    PipelinedTrainer(lru).init(0, _batches(1)[0], emb_shards=2)
    assert all(isinstance(b, BK.ShardedBackend) and b.n_shards == 2
               for b in lru.backends.values())
    with pytest.raises(ValueError, match="unknown tables"):
        PipelinedTrainer(tr).init(0, _batches(1)[0], emb_shards={"zz": 2})


@pytest.mark.timeout(120)
def test_run_steps_cap_and_delegated_surface(tmp_path):
    batches = _batches(10)
    tr = _trainer("dense", mode=TrainMode.hybrid(2))
    engine = PipelinedTrainer(tr, max_inflight=2)
    assert engine.device == torch.device("cpu")
    state = engine.init(0, batches[0])
    state, ms = engine.run(state, batches, steps=6)
    assert len(ms) == 6 and state.step == 6
    # the delegated serial surface keeps working on the pipelined state
    m = engine.eval(state, batches[0])
    assert np.isfinite(float(m["loss"]))
    assert engine.predict(state, batches[0]).shape == (32, 1)
    engine.save(str(tmp_path), state)
    restored = engine.restore(str(tmp_path))
    assert restored.step == 6
    state2, _ = engine.run(restored, batches[6:])
    assert state2.step == 10


# ---------------------------------------------------------------------------
# slot pinning: deep pipelines must never fault-recycle in-flight rows
# ---------------------------------------------------------------------------

def test_host_lru_pinned_slots_survive_fault_in():
    """While a batch is in flight (pinned), a later fault-in must evict
    around its slots — or raise when it can't — never recycle them."""
    spec = EmbeddingSpec(rows=64, dim=4, mode="full", optimizer="sgd",
                         backend="host_lru", cache_rows=8)
    bk = create_backend(spec)
    state = bk.init(torch.Generator().manual_seed(0))
    state, dev0 = bk.prepare(state, np.arange(0, 6))        # batch 0: 6 slots
    bk.pin_slots(dev0)
    # 2 unpinned slots remain; a 2-id disjoint batch fits around the pins
    state, dev1 = bk.prepare(state, np.array([10, 11]))
    assert not set(np.asarray(dev1).tolist()) & \
        set(np.asarray(dev0).tolist())
    for i in range(6):                          # batch 0 still resident
        assert bk._slot_for_id[i] == int(np.asarray(dev0)[i])
    # ... but a batch needing more than the unpinned residue must raise,
    # not silently recycle pinned rows
    with pytest.raises(ValueError, match="pinned"):
        bk.prepare(state, np.array([20, 21, 22]))
    bk.unpin_slots(dev0)
    state, _ = bk.prepare(state, np.array([20, 21, 22]))    # now fine
    assert bk._pin_count.sum() == 0


@pytest.mark.timeout(240)
def test_deep_pipeline_pins_inflight_rows_host_lru():
    """A deep pipeline with a slow put stage keeps several batches in
    flight: pins make later fault-ins evict around in-flight rows, every
    put applies in order and every pin is released."""
    batches = _batches(10, batch=8)
    tr = _trainer("host_lru", RPF, TrainMode.hybrid(2))
    engine = PipelinedTrainer(
        tr, max_inflight=3,
        delay_fn=lambda s, i: 0.02 if s == "put" else 0.0)
    state, ms = engine.run(engine.init(0, batches[0]), batches)
    assert len(ms) == 10
    assert engine.applied_order == list(range(10))
    for n in tr.collection.names:                  # every pin released
        assert tr.backends[n]._pin_count.sum() == 0, n


@pytest.mark.timeout(120)
def test_host_lru_prepare_is_thread_safe():
    """Two threads hammering prepare on one backend: the slot bookkeeping
    must stay an exact bijection and never raise."""
    spec = EmbeddingSpec(rows=512, dim=4, mode="full", optimizer="sgd",
                         backend="host_lru", cache_rows=96)
    bk = create_backend(spec)
    state0 = bk.init(torch.Generator().manual_seed(0))
    errors = []
    go = threading.Event()

    def hammer(seed):
        rng = np.random.default_rng(seed)
        go.wait()
        try:
            for _ in range(60):
                ids = rng.integers(0, spec.rows, 24)
                _, dev = bk.prepare(state0, ids)
                dev = np.asarray(dev)
                assert ((dev >= 0) & (dev < spec.cache_rows)).all()
        except Exception as e:   # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(set(bk._slot_for_id.values())) == len(bk._slot_for_id)
    for k, s in bk._slot_for_id.items():
        assert int(bk._id_for_slot[s]) == k
    occupied = {int(s) for s in np.nonzero(bk._id_for_slot >= 0)[0]}
    assert occupied == set(bk._slot_for_id.values())


def test_pins_of_prepared_plans_read_no_device_copy(monkeypatch):
    """``pin_slots`` / ``unpin_slots`` on the plans of a ``prepare_all``
    read the plans' host copies: no ``Tensor.cpu`` (on the card, a wait
    for the stream) is called."""
    tr = _trainer("host_lru", 100)
    state = tr.init(0, _batches(1)[0])
    ids = tr.adapter.emb_ids(_batches(1, seed=3)[0])
    _, dev_ids, _ = BK.prepare_all(tr.backends, state.emb, ids, "cpu")

    def no_cpu(self, *a, **k):
        raise AssertionError("Tensor.cpu called")
    monkeypatch.setattr(torch.Tensor, "cpu", no_cpu)
    for n, b in tr.backends.items():
        plan = dev_ids[n]
        assert plan.host is not None
        b.pin_slots(plan)
        assert int(b._pin_count.sum()) == plan.n_unique > 0
        b.unpin_slots(plan)
        assert int(b._pin_count.sum()) == 0


def test_prepare_all_pins_under_its_lock():
    """``prepare_all(lock=, pins=)``: the state-touching phase runs under
    the lock, and each table's host device ids are pinned and handed back
    for the unpin (a flat table's too)."""
    tr = _trainer("host_lru", 100)
    state = tr.init(0, _batches(1)[0])
    held = []

    class Probe:
        def __enter__(self):
            held.append(True)

        def __exit__(self, *a):
            held.append(False)

    b0 = tr.backends["field_00"]
    b0.spec = dataclasses.replace(b0.spec, batch_dedup=False)
    pins = {}
    ids = tr.adapter.emb_ids(_batches(1, seed=4)[0])
    _, dev_ids, _ = BK.prepare_all(tr.backends, state.emb, ids, "cpu",
                                   lock=Probe(), pins=pins)
    assert held == [True, False]
    assert set(pins) == set(tr.collection.names)
    assert isinstance(dev_ids["field_00"], torch.Tensor)
    assert np.array_equal(pins["field_00"], dev_ids["field_00"].numpy())
    assert pins["field_01"] is dev_ids["field_01"].host
    for n, b in tr.backends.items():
        assert int(b._pin_count.sum()) == int((pins[n] >= 0).sum())
        b.unpin_slots(pins[n])
        assert int(b._pin_count.sum()) == 0


# ---------------------------------------------------------------------------
# prefetch (the ports of tests/test_cache_tiers.py's prefetch tests)
# ---------------------------------------------------------------------------

@pytest.mark.timeout(240)
def test_prefetch_bit_exact_with_serial_at_inflight_1():
    """prefetch=2 at max_inflight=1 with an eviction-free cache: the
    look-ahead fault-in changes WHEN rows fault, not which rows or what
    the step computes — the run equals the serial trainer bit for bit."""
    batches = _batches(20)
    ta = _trainer("host_lru", RPF)
    sa, ms_a = ta.run(ta.init(0, batches[0]), batches)
    tb = _trainer("host_lru", RPF)
    engine = PipelinedTrainer(tb, max_inflight=1, prefetch=2)
    sb, ms_b = engine.run(tb.init(0, batches[0]), batches)
    assert _losses(ms_a) == _losses(ms_b)
    _assert_states_equal(sa, sb)
    pm = engine.pipeline_metrics()
    assert pm["pipeline/prefetch/items"] == 20.0
    assert pm["pipeline/prepare/busy_s"] <= pm["pipeline/prefetch/busy_s"]


@pytest.mark.timeout(240)
def test_prefetch_deep_pipeline_is_lossless_and_learns(tmp_path):
    """prefetch over the full three-tier stack at max_inflight > 1: all
    puts applied in order, pins released, losses finite."""
    coll = adapters.ctr_collection(CFG, lr=5e-2, field_rows=DS.field_rows())
    coll = coll.with_backend("host_lru+disk", RPF)
    # one mmap directory per table: the store writes fixed file names
    coll = coll.map_specs(lambda n, s: dataclasses.replace(
        s, host_rows=64, disk_path=str(tmp_path / n)))
    ad = adapters.recsys_adapter(CFG, field_rows=DS.field_rows(),
                                 collection=coll)
    tr = PersiaTrainer(ad, TrainMode.hybrid(3),
                       OptConfig(kind="adam", lr=5e-3), device="cpu")
    engine = PipelinedTrainer(tr, max_inflight=3, prefetch=2)
    batches = _batches(12)
    state = engine.init(0, batches[0])
    state, ms = engine.run(state, batches)
    assert len(ms) == 12
    assert engine.applied_order == list(range(12))
    assert all(np.isfinite(_losses(ms)))
    for bk in tr.backends.values():
        assert int(np.asarray(bk._pin_count).sum()) == 0


def test_prefetch_rejects_negative():
    with pytest.raises(ValueError, match="prefetch"):
        PipelinedTrainer(_trainer("host_lru", RPF), max_inflight=1,
                         prefetch=-1)


# ---------------------------------------------------------------------------
# the port's pipeline against JAX's, from one JAX-exported start
# ---------------------------------------------------------------------------

JCFG = JConfig(**dataclasses.asdict(CFG))
JDS = jctr.CTRDataset(**dataclasses.asdict(DS))
JMODES = {"sync": jhybrid.TrainMode.sync(),
          "hybrid": jhybrid.TrainMode.hybrid(3),
          "async": jhybrid.TrainMode.async_(3, 3)}


def _jax_pair(backend, cache, mode):
    jcoll = jadapters.ctr_collection(JCFG, lr=5e-2,
                                     field_rows=JDS.field_rows())
    tcoll = adapters.ctr_collection(CFG, lr=5e-2, field_rows=DS.field_rows())
    if backend != "dense":
        jcoll = jcoll.with_backend(backend, cache)
        tcoll = tcoll.with_backend(backend, cache)
    jt = jhybrid.PersiaTrainer(
        jadapters.recsys_adapter(JCFG, field_rows=JDS.field_rows(),
                                 collection=jcoll),
        JMODES[mode], jopt.OptConfig(kind="adam", lr=5e-3))
    tt = PersiaTrainer(
        adapters.recsys_adapter(CFG, field_rows=DS.field_rows(),
                                collection=tcoll),
        MODES[mode], OptConfig(kind="adam", lr=5e-3), device="cpu")
    return jt, tt


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("backend,cache,prefetch", [
    ("dense", None, 0), ("host_lru", 24, 0), ("dense+compressed", None, 0)],
    ids=["dense", "host_lru_evicts", "dense+compressed"])
@pytest.mark.parametrize("mode", list(MODES))
def test_pipeline_matches_jax_pipeline(backend, cache, prefetch, mode):
    """4 steps of the port's PipelinedTrainer(max_inflight=1) against JAX's
    from the JAX-exported start: losses per step and the final state in
    the FFNN's class (lossy behind the wire), a host_lru table's slot map,
    counters and queue slots exactly."""
    _jax_parity(backend, cache, prefetch, mode)


@pytest.mark.timeout(300)
def test_pipeline_prefetch_matches_jax_pipeline():
    """host_lru with ``prefetch=2`` at max_inflight=1, hybrid(3)."""
    _jax_parity("host_lru", RPF, 2, "hybrid")


def _jax_parity(backend, cache, prefetch, mode):
    jt, tt = _jax_pair(backend, cache, mode)
    batches = _batches(4, batch=16, seed=5)
    js = jt.init(jax.random.PRNGKey(0), _jnp(batches[0]))
    lru = backend.startswith("host_lru")
    ts = convert.state_from_numpy(
        tt, _to_np(js.dense), _blobs(jt, js.emb) if lru else _to_np(js.emb),
        opt=_to_np(js.opt), emb_queue=_to_np(js.emb_queue),
        dense_queue=_to_np(js.dense_queue), step=int(js.step))
    start, start_emb = _to_np(js.dense), _to_np(js.emb)
    js, jm = JPipelinedTrainer(jt, max_inflight=1, prefetch=prefetch).run(
        js, [_jnp(b) for b in batches])
    ts, tm = PipelinedTrainer(tt, max_inflight=1, prefetch=prefetch).run(
        ts, batches)
    _close(_losses(tm), [float(m["loss"]) for m in jm], 1e-5, 0, "losses")
    if backend.endswith("compressed"):
        _check_wire_states(ts, js, start, start_emb)
    else:
        _check_states(ts, js)
    if lru:
        _check_tiers(tt, ts, jt, js)
        assert BK.unwrap(tt.backends["field_00"]).writebacks > 0 or \
            cache == RPF


def _rel(got, want, base=None) -> float:
    """||got - want|| over ||want - base|| (over ||want|| without a
    base), across the leaves of two trees."""
    g = [np.asarray(x, np.float64) for x in tree_leaves(got)]
    w = [np.asarray(x, np.float64) for x in tree_leaves(want)]
    b = [0.0] * len(w) if base is None else \
        [np.asarray(x, np.float64) for x in tree_leaves(base)]
    num = sum(((x - y) ** 2).sum() for x, y in zip(g, w))
    den = sum(((y - z) ** 2).sum() for y, z in zip(w, b))
    return float((num / max(den, 1e-300)) ** 0.5)


def _check_wire_states(ts, js, start, start_emb):
    """Behind the lossy wire, now and then a value of the two packages
    lands on either side of an fp16 rounding boundary and moves by one
    fp16 step, and the steps after it carry that on. So every float is
    held as ``chip_smoke.py``'s card-against-CPU check holds it: its
    update from the start agrees to 1e-3 in norm, and no element is off by
    more than a bound — 1e-4 for a table element (``_close_lossy``'s),
    2^-10 of the largest for an accumulator or a queued grad, 2 lr a step
    for a dense weight; Adam's moments and the dense delay queue agree to
    1e-3 in norm; integers exactly. (``_close_lossy``'s 1% limit on the
    elements off does not apply at this size: the flips of one 128-wide
    block move 12 elements of a 1,024-element table.)"""
    got, want = convert.state_to_numpy(ts), _to_np(js)
    steps = int(want.step)
    assert int(got["step"]) == steps
    assert int(got["opt"]["t"]) == int(want.opt["t"])
    assert _rel(got["dense"], want.dense, start) <= 1e-3
    for g, w in zip(tree_leaves(got["dense"]), tree_leaves(want.dense)):
        _close(g, w, 0, 2 * 5e-3 * steps, "dense")
    for k in ("m", "v"):
        assert _rel(got["opt"][k], want.opt[k]) <= 1e-3, k
    for n in want.emb:
        for k in ("table", "acc"):
            g, w = got["emb"][n][k], want.emb[n][k]
            assert _rel(g, w, start_emb[n][k]) <= 1e-3, (n, k)
            _close(g, w, 0, 1e-4 if k == "table"
                   else 2.0 ** -10 * np.abs(w).max(), f"{n}.{k}")
        gq, wq = got["emb_queue"][n], want.emb_queue[n]
        assert (gq is None) == (wq is None)
        if wq is not None:
            np.testing.assert_array_equal(gq["ids"], wq["ids"])
            assert (int(gq["ptr"]), int(gq["filled"])) == \
                (int(wq["ptr"]), int(wq["filled"]))
            assert _rel(gq["grads"], wq["grads"]) <= 1e-3, n
            _close(gq["grads"], wq["grads"], 0,
                   2.0 ** -10 * np.abs(wq["grads"]).max(), f"{n} queue")
    gd, wd = got["dense_queue"], want.dense_queue
    assert (gd is None) == (wd is None)
    if wd is not None:
        assert (int(gd["ptr"]), int(gd["filled"])) == \
            (int(wd["ptr"]), int(wd["filled"]))
        assert _rel(gd["grads"], wd["grads"]) <= 1e-3


# ---------------------------------------------------------------------------
# the collection facade against JAX's
# ---------------------------------------------------------------------------

def _collections(staleness=0):
    specs = {"a": (50, 8, "adagrad"), "b": (5000, 4, "sgd")}
    return (JCollection.from_dict({
        n: JSpec(rows=r, dim=d, mode="full", optimizer=o,
                 staleness=staleness) for n, (r, d, o) in specs.items()}),
        EmbeddingCollection.from_dict({
            n: EmbeddingSpec(rows=r, dim=d, mode="full", optimizer=o,
                             staleness=staleness)
            for n, (r, d, o) in specs.items()}))


def test_collection_sizes_membership_and_overrides_match_jax():
    jc, tc = _collections()
    assert (tc.total_rows, tc.total_params) == (jc.total_rows,
                                                jc.total_params)
    assert ("a" in tc, "z" in tc) == ("a" in jc, "z" in jc) == (True, False)
    on = tc.with_backward_kernel(True)
    assert all(s.backward_kernel for _, s in on.items())
    assert not any(s.backward_kernel
                   for _, s in on.with_backward_kernel(False).items())
    assert EmbeddingSpec(rows=2, dim=2).backward_kernel == \
        JSpec(rows=2, dim=2).backward_kernel
    assert tc.with_shards(1) == tc and tc.with_shards({"a": 1}) == tc
    for many in (2, {"a": 3}):
        assert [s.emb_shards for _, s in tc.with_shards(many).items()] == \
            [s.emb_shards for _, s in jc.with_shards(many).items()]
    for bad, what in (({"z": 2}, "unknown tables"), ({"a": 0}, ">= 1"),
                      (0, ">= 1")):
        with pytest.raises(ValueError, match=what):
            tc.with_shards(bad)
        if not isinstance(bad, int):
            with pytest.raises(ValueError, match=what):
                jc.with_shards(bad)
    coll = adapters.ctr_collection(CFG, field_rows=DS.field_rows())
    assert apply_backend_choice(coll, "dense") is coll
    assert apply_backend_choice(coll, "dense+compressed", 64)[
        "field_00"].cache_rows == 0
    lru = apply_backend_choice(coll, "host_lru+disk", 64)["field_00"]
    assert (lru.backend, lru.cache_rows) == ("host_lru+disk", 64)


def test_collection_init_lookup_and_puts_match_jax():
    """``init`` draws each table's state (shapes and dtypes as JAX's);
    ``lookup`` and ``apply_put`` from one numpy state equal JAX's: the
    gathers bit for bit, the puts (adagrad and sgd, shared shuffled rows
    in the 5,000-row table) to 1 ulp-class tolerance (rtol 1e-6)."""
    jc, tc = _collections()
    js = jc.init(jax.random.PRNGKey(0))
    ts = tc.init(torch.Generator().manual_seed(0))
    for n in js:
        assert {k: tuple(v.shape) for k, v in ts[n].items()} == \
            {k: tuple(v.shape) for k, v in js[n].items()}
    ts = {n: {k: torch.from_numpy(np.array(v)) for k, v in js[n].items()}
          for n in js}
    rng = np.random.default_rng(0)
    ids = {"a": rng.integers(-1, 50, (6, 3)),
           "b": rng.integers(-1, 5000, (6, 3))}
    grads = {"a": rng.standard_normal((6, 3, 8)).astype(np.float32),
             "b": rng.standard_normal((6, 3, 4)).astype(np.float32)}
    jl = jc.lookup(js, {n: jnp.asarray(v, jnp.int32) for n, v in ids.items()})
    tl = tc.lookup(ts, {n: torch.from_numpy(v) for n, v in ids.items()})
    for n in ids:
        np.testing.assert_array_equal(tl[n].numpy(), np.asarray(jl[n]))
    jp = jc.apply_put(js, {n: jnp.asarray(v, jnp.int32)
                           for n, v in ids.items()},
                      {n: jnp.asarray(v) for n, v in grads.items()})
    tp = tc.apply_put(ts, {n: torch.from_numpy(v) for n, v in ids.items()},
                      {n: torch.from_numpy(v) for n, v in grads.items()})
    for n in ids:
        for k in jp[n]:
            np.testing.assert_allclose(tp[n][k].numpy(),
                                       np.asarray(jp[n][k]), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{n}.{k}")
    with pytest.raises(KeyError, match="unknown"):
        tc.lookup(ts, {"z": torch.zeros(2, dtype=torch.int64)})


def test_collection_queues_and_hybrid_update_match_jax():
    """``queue_init`` shapes and ``hybrid_update`` over tau+1 puts from one
    numpy state: queue ids and ring pointers exactly, tables, accumulators
    and queued grads to rtol 1e-6."""
    jc, tc = _collections(staleness=2)
    shapes = {"a": (6, 3), "b": (6, 3)}
    jq = jc.queue_init(shapes)
    tq = tc.queue_init(shapes)
    for n in shapes:
        assert tuple(tq[n]["ids"].shape) == tuple(jq[n]["ids"].shape)
        assert tuple(tq[n]["grads"].shape) == tuple(jq[n]["grads"].shape)
    assert tc.queue_init({"a": (2,)})["b"] is None
    js = jc.init(jax.random.PRNGKey(1))
    ts = {n: {k: torch.from_numpy(np.array(v)) for k, v in js[n].items()}
          for n in js}
    rng = np.random.default_rng(1)
    for _ in range(3):
        ids = {"a": rng.integers(-1, 50, (6, 3)),
               "b": rng.integers(-1, 5000, (6, 3))}
        grads = {"a": rng.standard_normal((6, 3, 8)).astype(np.float32),
                 "b": rng.standard_normal((6, 3, 4)).astype(np.float32)}
        js, jq = jc.hybrid_update(
            js, jq, {n: jnp.asarray(v, jnp.int32) for n, v in ids.items()},
            {n: jnp.asarray(v) for n, v in grads.items()})
        ts, tq = tc.hybrid_update(
            ts, tq, {n: torch.from_numpy(v) for n, v in ids.items()},
            {n: torch.from_numpy(v) for n, v in grads.items()})
    for n in shapes:
        np.testing.assert_array_equal(tq[n]["ids"].numpy(),
                                      np.asarray(jq[n]["ids"]))
        assert (tq[n]["ptr"], tq[n]["filled"]) == \
            (int(jq[n]["ptr"]), int(jq[n]["filled"]))
        np.testing.assert_allclose(tq[n]["grads"].numpy(),
                                   np.asarray(jq[n]["grads"]), rtol=1e-6)
        for k in js[n]:
            np.testing.assert_allclose(ts[n][k].numpy(),
                                       np.asarray(js[n][k]), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{n}.{k}")


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def test_checkpoint_manager_keeps_the_newest_three(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=2)
    tr = _trainer("dense", mode=TrainMode.hybrid(2))
    batches = _batches(10)
    state = tr.init(0, batches[0])
    saved = []
    for i, b in enumerate(batches, 1):
        state, _ = tr.step(state, b)
        saved.append(mgr.maybe_save_state(i, tr, state))
    assert saved[0] is None and saved[1].endswith("step_00000002")
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000006", "step_00000008", "step_00000010"]
    assert mgr.maybe_save(11, {"w": torch.ones(2)}) is None
    mgr.maybe_save(12, {"w": torch.ones(2)}, {"e": np.zeros(3)})
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000008", "step_00000010", "step_00000012"]
    step, dense, emb = load_checkpoint(str(tmp_path))
    assert step == 12 and np.array_equal(dense["w"], np.ones(2))
    assert tr.restore(str(tmp_path), step=10).step == 10


# ---------------------------------------------------------------------------
# the CTR launcher
# ---------------------------------------------------------------------------

def _launch(tmp_path, tag, *extra):
    argv = ["--device", "cpu", "--batch", "32", "--eval-every", "4",
            "--mode", "hybrid", "--ckpt-dir", str(tmp_path / tag),
            "--ckpt-every", "4", *extra]
    return launch_train.main(argv)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("pipeline", ["fused", "decomposed", "pipelined"])
def test_launcher_trains_and_resumes_bit_identically(tmp_path, pipeline,
                                                     capsys):
    """8 steps straight against 4 steps and a ``--resume`` to 8: the two
    step-8 checkpoints are equal bit for bit; serial and decomposed are
    one computation, and at --max-inflight 1 so is the pipelined run."""
    flags = ["--pipeline", pipeline, "--max-inflight", "1"]
    hist = _launch(tmp_path, "straight", "--steps", "8", *flags,
                   "--out", str(tmp_path / "out.json"))
    assert [h["step"] for h in hist] == [4, 8]
    assert all(np.isfinite(h["loss"]) and 0 <= h["auc"] <= 1 for h in hist)
    _launch(tmp_path, "split", "--steps", "4", *flags)
    resumed = _launch(tmp_path, "split", "--steps", "8", "--resume", *flags)
    assert "resumed full state from step 4" in capsys.readouterr().out
    assert [h["step"] for h in resumed] == [8]
    assert resumed[0]["loss"] == hist[1]["loss"]
    a = load_checkpoint(str(tmp_path / "straight"), 8)
    b = load_checkpoint(str(tmp_path / "split"), 8)
    assert a[0] == b[0] == 8
    for x, y in zip(tree_leaves([a[1], a[2]]), tree_leaves([b[1], b[2]])):
        np.testing.assert_array_equal(x, y)
    if pipeline == "pipelined":
        import json
        rec = json.loads((tmp_path / "out.json").read_text())
        assert rec["pipeline_metrics"]["pipeline/max_inflight"] == 1.0
        assert rec["device"] == "cpu"


def test_launcher_modes_agree():
    """fused, decomposed and pipelined at max_inflight 1 train the same
    8 steps to the same losses (the same computation in the same order)."""
    runs = [launch_train.main(["--device", "cpu", "--batch", "32",
                               "--steps", "8", "--eval-every", "4",
                               "--pipeline", p, "--max-inflight", "1"])
            for p in ("fused", "decomposed", "pipelined")]
    for other in runs[1:]:
        assert [(h["loss"], h["auc"]) for h in other] == \
            [(h["loss"], h["auc"]) for h in runs[0]]


def test_launcher_refuses_what_is_not_ported():
    # --emb-shards trains over the sharded router (every table, or the
    # named ones)
    for shards in ("2", "field_00=2"):
        hist = launch_train.main(["--device", "cpu", "--emb-shards", shards,
                                  "--batch", "32", "--steps", "2",
                                  "--eval-every", "2"])
        assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--resume", "--steps", "1"])
    args = launch_train.parse_args([])
    assert (args.device, args.pipeline, args.max_inflight) == \
        ("cuda", "fused", 4)
    assert launch_train.mode_from_name("async", 2) == TrainMode.async_(2, 2)


# ---------------------------------------------------------------------------
# the tuned-host profile
# ---------------------------------------------------------------------------

def test_tuned_host_reexecs_once_with_tcmalloc(monkeypatch):
    env = {"LD_PRELOAD": "/lib/other.so"}
    monkeypatch.setattr(hostenv.os, "environ", env)
    monkeypatch.setattr(hostenv, "find_tcmalloc",
                        lambda: "/usr/lib/x/libtcmalloc.so.4")
    calls = []

    class Execd(Exception):
        pass

    def fake_execv(path, argv):
        calls.append((path, argv))
        raise Execd

    monkeypatch.setattr(hostenv.os, "execv", fake_execv)
    with pytest.raises(Execd):
        hostenv.apply_tuned_host()
    assert calls == [(sys.executable, [sys.executable] + sys.argv)]
    assert env["LD_PRELOAD"] == "/usr/lib/x/libtcmalloc.so.4:/lib/other.so"
    assert env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "60000000000"
    assert "XLA_FLAGS" not in env and "TF_CPP_MIN_LOG_LEVEL" not in env
    # the re-exec'd process inherits the marker and falls through
    assert hostenv.apply_tuned_host() == "already"
    assert len(calls) == 1


def test_tuned_host_without_tcmalloc_or_already_preloaded(monkeypatch):
    monkeypatch.setattr(hostenv.os, "execv", lambda *a: pytest.fail("exec"))
    monkeypatch.setattr(hostenv.os, "environ", {})
    monkeypatch.setattr(hostenv, "find_tcmalloc", lambda: None)
    assert hostenv.apply_tuned_host() == "no-tcmalloc"
    lib = "/usr/lib/x/libtcmalloc.so.4"
    monkeypatch.setattr(hostenv.os, "environ", {"LD_PRELOAD": lib})
    monkeypatch.setattr(hostenv, "find_tcmalloc", lambda: lib)
    assert hostenv.apply_tuned_host() == "preloaded"
    assert hostenv.tuned_env() == {
        "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000"}


# ---------------------------------------------------------------------------
# launch counters under threads
# ---------------------------------------------------------------------------

class _Yielding(int):
    """An int whose sum sleeps for 0 s first: the interpreter lock is
    released in the middle of ``count += n``."""

    def __add__(self, other):
        time.sleep(0)
        return _Yielding(int(self) + int(other))


@pytest.mark.timeout(120)
def test_launch_counts_are_exact_under_two_threads(monkeypatch):
    """Two threads drive grouped compress and decompress calls (the
    pipelined trainer's lookup and put stages both run the codec); every
    launch and every table is counted. The launch itself is stubbed: the
    CPU has no kernel, and the counting is what is under test. The counts
    start as ints whose addition yields the interpreter lock, so an
    unguarded read-modify-write would lose updates."""
    monkeypatch.setattr(ops, "_all_on_cpu", lambda *ts: False)
    monkeypatch.setattr(ops, "_check_group",
                        lambda op, items: torch.device("cpu"))
    monkeypatch.setattr(ops, "_launch_grouped", lambda *a: 1)
    vs = [torch.ones(256), torch.ones(128)]
    comps = [torch.zeros((2, 128), dtype=torch.float16),
             torch.zeros((1, 128), dtype=torch.float16)]
    scales = [torch.ones(2), torch.ones(1)]
    n = 2000
    errors = []

    def drive():
        try:
            for _ in range(n):
                ops.blockscale_compress_grouped(vs)
                ops.blockscale_decompress_grouped(comps, scales,
                                                  [(256,), (128,)])
        except Exception as e:   # noqa: BLE001
            errors.append(e)

    ops.reset_launch_counts()
    for fn in (ops.blockscale_compress, ops.blockscale_decompress):
        monkeypatch.setattr(fn, "launches", _Yielding(0))
        monkeypatch.setattr(fn, "tables", _Yielding(0))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=drive) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=100)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    counts, tables = ops.launch_counts(), ops.table_counts()
    ops.reset_launch_counts()
    assert counts["blockscale_compress"] == 2 * n
    assert counts["blockscale_decompress"] == 2 * n
    assert tables["blockscale_compress"] == 4 * n
    assert tables["blockscale_decompress"] == 4 * n
