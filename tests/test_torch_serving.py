"""The port's ServingService (repro_torch/serving) on the CPU: micro-batching
against single requests and against the JAX service, flush triggers, error
propagation, stop, the staleness gauge, and serve-while-train (readers
under the cell's lock see the serial trajectory).

Tolerance: a micro-batch pads to ``max_batch`` rows, so batch-1 and batch-8
services run the FFNN at different GEMM shapes, which may reduce in another
order; predictions are compared with rtol 1e-5, atol 1e-6 (the JAX twin of
the first test demands bit-equality and fails on the CPU for that reason).
Serve-while-train: the readers' pooled rows bit for bit against the port's
own serial run; that run's pooled rows against JAX's ``step`` and
``serve_lookup`` from one checkpoint in the same rtol 1e-5 / atol 1e-6
(torch and XLA round the FFNN's backward differently).
"""
import threading
import time

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JConfig
from repro.core import adapters as jadapters
from repro.core.hybrid import PersiaTrainer as JTrainer
from repro.core.hybrid import TrainMode as JMode
from repro.optim.optimizers import OptConfig
from repro.serving import ServingConfig as JServingConfig
from repro.serving import ServingService as JServingService
from repro.serving import StateCell as JStateCell

from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapters
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.data.ctr import CTRDataset
from repro_torch.optim.optimizers import OptConfig as TOptConfig
from repro_torch.serving import (ServingConfig, ServingService, StateCell,
                                 TrafficModel)
from repro_torch.serving.service import queue_lag

F, RPF, D = 2, 64, 8
KW = dict(name="srv", arch_type="recsys", n_id_fields=F, ids_per_field=3,
          emb_dim=D, emb_rows=F * RPF, n_dense_features=4, mlp_dims=(16,),
          n_tasks=2)
CFG = ModelConfig(**KW)
DS = CTRDataset("srv", n_rows=F * RPF, n_fields=F, ids_per_field=3,
                n_dense=4, n_tasks=2)
RTOL, ATOL = 1e-5, 1e-6


def _trainer(dedup_on=True):
    ad = adapters.recsys_adapter(CFG, field_rows=DS.field_rows())
    return PersiaTrainer(ad, TrainMode.sync(), batch_dedup=dedup_on,
                         device="cpu")


def _requests(n, seed=0):
    tm = TrafficModel.for_dataset(DS, n_users=500)
    return [r for _, r in tm.requests(n, seed=seed)]


@pytest.mark.parametrize("dedup_on", [True, False])
def test_micro_batched_equals_single_request(dedup_on):
    trainer = _trainer(dedup_on)
    cell = StateCell(trainer.init(seed=0), 0)
    reqs = _requests(12)
    with ServingService(trainer, cell, ServingConfig(1, 0.0)) as svc:
        single = svc.predict_many(reqs)
    with ServingService(trainer, cell, ServingConfig(8, 50.0)) as svc:
        futs = [svc.submit(r) for r in reqs]
        batched = np.stack([f.result(30.0) for f in futs])
        assert svc.metrics()["serving/batches"] >= 2
    assert batched.shape == (12, CFG.n_tasks)
    np.testing.assert_allclose(batched, single, rtol=RTOL, atol=ATOL)
    # and the trainer's own predict on the same requests
    batch = {"ids": np.stack([r["ids"] for r in reqs]),
             "dense": np.stack([r["dense"] for r in reqs])}
    np.testing.assert_allclose(
        trainer.predict(cell.snapshot()[0], batch).numpy(), single,
        rtol=RTOL, atol=ATOL)


def test_served_predictions_match_jax_service():
    jad = jadapters.recsys_adapter(JConfig(**KW), field_rows=DS.field_rows())
    jt = JTrainer(jad, JMode.sync(), OptConfig(kind="adam", lr=1e-3))
    jstate = jt.init(jax.random.PRNGKey(1))
    trainer = _trainer()
    state = convert.state_from_numpy(
        trainer, jax.tree.map(np.asarray, jstate.dense),
        jax.tree.map(np.asarray, jstate.emb))
    reqs = _requests(10, seed=3)
    with JServingService(jt, JStateCell(jstate, 0),
                         JServingConfig(4, 20.0)) as jsvc:
        want = jsvc.predict_many(reqs)
    with ServingService(trainer, StateCell(state, 0),
                        ServingConfig(4, 20.0)) as svc:
        got = svc.predict_many(reqs)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_flush_on_max_batch_not_timeout():
    trainer = _trainer()
    cell = StateCell(trainer.init(seed=0), 0)
    svc = ServingService(trainer, cell,
                         ServingConfig(max_batch=4, max_wait_ms=60_000))
    with svc:
        svc.predict_many(_requests(4))          # full batch: flushes now
        m = svc.metrics()
    assert m["serving/batches"] == 1
    assert m["serving/field_00/batch_fill"] == 1.0
    assert m["serving/requests"] == 4 and m["serving/p99_ms"] > 0


def test_flush_on_timeout_with_partial_batch():
    trainer = _trainer()
    cell = StateCell(trainer.init(seed=0), 0)
    svc = ServingService(trainer, cell,
                         ServingConfig(max_batch=64, max_wait_ms=30.0))
    with svc:
        p = svc.predict(_requests(1)[0], timeout=30.0)   # alone in queue
        m = svc.metrics()
    assert p.shape == (CFG.n_tasks,)
    assert m["serving/batches"] == 1
    assert m["serving/field_00/batch_fill"] < 1.0


def test_flush_error_reaches_every_waiting_request_and_loop_survives():
    trainer = _trainer()
    cell = StateCell(trainer.init(seed=0), 0)
    real = trainer.serve_lookup
    calls = []

    def flaky(state, batch):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("backend read failed")
        return real(state, batch)

    trainer.serve_lookup = flaky
    reqs = _requests(3)
    with ServingService(trainer, cell,
                        ServingConfig(max_batch=3, max_wait_ms=60_000)) as svc:
        futs = [svc.submit(r) for r in reqs]
        for f in futs:
            with pytest.raises(RuntimeError, match="backend read failed"):
                f.result(30.0)
        ok = svc.predict_many(reqs)
        m = svc.metrics()
    assert ok.shape == (3, CFG.n_tasks) and np.isfinite(ok).all()
    assert m["serving/errors"] == 1.0


def test_stop_drains_queued_requests_and_refuses_new_ones():
    trainer = _trainer()
    cell = StateCell(trainer.init(seed=0), 0)
    svc = ServingService(trainer, cell,
                         ServingConfig(max_batch=64, max_wait_ms=60_000))
    svc.start()
    with pytest.raises(RuntimeError, match="already started"):
        svc.start()
    futs = [svc.submit(r) for r in _requests(3)]
    svc.stop()                      # the loop waits for a full batch: stop
    for f in futs:                  # must flush what is queued
        assert f.result(0).shape == (CFG.n_tasks,)
    with pytest.raises(RuntimeError, match="not running"):
        svc.submit(_requests(1)[0])


def test_concurrent_clients_get_their_own_predictions():
    trainer = _trainer()
    cell = StateCell(trainer.init(seed=0), 0)
    reqs = _requests(40, seed=7)
    with ServingService(trainer, cell, ServingConfig(1, 0.0)) as svc:
        want = svc.predict_many(reqs)
    got = [None] * len(reqs)
    with ServingService(trainer, cell, ServingConfig(8, 5.0)) as svc:
        def client(k):
            for i in range(k, len(reqs), 4):
                got[i] = svc.predict(reqs[i], timeout=30.0)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60.0)
        assert not any(th.is_alive() for th in threads)
    np.testing.assert_allclose(np.stack(got), want, rtol=RTOL, atol=ATOL)


def test_staleness_gauge_is_zero_without_queues():
    trainer = _trainer()
    state = trainer.init(seed=0)
    cell = StateCell(state, 0)
    with ServingService(trainer, cell, ServingConfig(2, 1.0)) as svc:
        svc.predict_many(_requests(2))
        assert svc.metrics()["serving/field_00/stale_steps"] == 0.0
        assert svc.metrics()["serving/field_01/hit_rate"] == 1.0


def test_queue_lag_helper():
    assert queue_lag(None, 5, 3) == 0
    assert queue_lag({"filled": np.int32(2)}, 5, 3) == 2
    assert queue_lag({"filled": 3}, 5, 0) == 0


# ---------------------------------------------------------------------------
# serve-while-train (port of tests/test_serving.py's concurrency check)
# ---------------------------------------------------------------------------

def _hybrid_pair(backend):
    """The JAX twin's trainers (tests/test_serving.py's ``_trainer``:
    hybrid(2), tables at lr 5e-2, host_lru at 40 slots, the router over 2
    shards) on this file's model: (JAX trainer, port trainer factory)."""
    def specs(coll):
        if backend == "sharded":
            return coll.with_shards(2)
        return coll if backend == "dense" else coll.with_backend(backend, 40)
    jcoll = specs(jadapters.ctr_collection(JConfig(**KW), lr=5e-2,
                                           field_rows=DS.field_rows()))
    jt = JTrainer(jadapters.recsys_adapter(JConfig(**KW),
                                           field_rows=DS.field_rows(),
                                           collection=jcoll),
                  JMode.hybrid(2), OptConfig(kind="adam", lr=5e-3))

    def port():
        coll = specs(adapters.ctr_collection(CFG, lr=5e-2,
                                             field_rows=DS.field_rows()))
        return PersiaTrainer(adapters.recsys_adapter(
            CFG, field_rows=DS.field_rows(), collection=coll),
            TrainMode.hybrid(2), TOptConfig(kind="adam", lr=5e-3),
            device="cpu")
    return jt, port


def _acts(pooled):
    return {n: np.asarray(a) for n, a in pooled.items()}


def _jax_pooled(jt, js, batch):
    """JAX's serve read (occurrence rows; an invalid id reads a zero row)
    pooled over each bag's ids, as the port's serve read pools."""
    rows, _ = jt.serve_lookup(js, {k: jax.numpy.asarray(v)
                                   for k, v in batch.items()})
    return {n: np.asarray(a).sum(1) for n, a in rows.items()}


@pytest.mark.parametrize("backend", ["dense", "host_lru", "sharded"])
def test_concurrent_reader_sees_serial_trajectory(backend, tmp_path):
    """Port of ``tests/test_serving.py::
    test_concurrent_reader_sees_serial_trajectory``: two reader threads
    reading the serve path under the cell's lock during training observe,
    at every published step, bit for bit the pooled rows the port's serial
    run reads at that step, and never perturb the trajectory. The serial
    run starts from JAX's checkpoint and holds JAX's ``step`` and
    ``serve_lookup`` at every step within rtol 1e-5 / atol 1e-6."""
    steps = 6
    it = DS.sampler(16, seed=0)
    bs = [next(it) for _ in range(steps + 1)]
    probe = bs[0]
    jt, port = _hybrid_pair(backend)
    js = jt.init(jax.random.PRNGKey(0),
                 {k: jax.numpy.asarray(v) for k, v in bs[0].items()})
    jt.save(str(tmp_path / "start"), js)

    ref_trainer = port()
    s = ref_trainer.restore(str(tmp_path / "start"))
    ref = {0: _acts(ref_trainer.serve_lookup(s, probe)[0])}
    jref = {0: _jax_pooled(jt, js, probe)}
    for t in range(steps):
        s, _ = ref_trainer.step(s, bs[t + 1])
        ref[t + 1] = _acts(ref_trainer.serve_lookup(s, probe)[0])
        js, _ = jt.step(js, {k: jax.numpy.asarray(v)
                             for k, v in bs[t + 1].items()})
        jref[t + 1] = _jax_pooled(jt, js, probe)
    for t in ref:
        for n, a in ref[t].items():
            np.testing.assert_allclose(a, jref[t][n], rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {t} {n}")

    trainer = port()
    state = trainer.restore(str(tmp_path / "start"))
    cell = StateCell(state, 0)
    errors, seen = [], set()
    done = threading.Event()

    def reader():
        while not done.is_set():
            with cell.lock:
                snap, t = cell.snapshot()
                acts = _acts(trainer.serve_lookup(snap, probe)[0])
            for n, a in acts.items():
                if not np.array_equal(a, ref[t][n]):
                    errors.append((t, n))
            seen.add(t)

    def read_at(t):
        # the port's steps are quick enough to starve the readers of the
        # lock: a step waits (outside it) until a reader read step t
        until = time.monotonic() + 30
        while t not in seen and time.monotonic() < until:
            time.sleep(1e-3)

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for th in threads:
        th.start()
    st = state
    for t in range(steps):
        read_at(t)
        with cell.lock:
            st, _ = trainer.step(st, bs[t + 1])
            cell.publish(st, t + 1)
    read_at(steps)
    done.set()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert not errors, f"reader saw non-serial rows at {errors[:5]}"
    assert seen == set(range(steps + 1))   # the readers overlapped
    with cell.lock:
        final = _acts(trainer.serve_lookup(st, probe)[0])
    for n, a in final.items():
        np.testing.assert_array_equal(a, ref[steps][n])
