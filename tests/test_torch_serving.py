"""The port's ServingService (repro_torch/serving) on the CPU: micro-batching
against single requests and against the JAX service, flush triggers, error
propagation, stop, and the staleness gauge.

Tolerance: a micro-batch pads to ``max_batch`` rows, so batch-1 and batch-8
services run the FFNN at different GEMM shapes, which may reduce in another
order; predictions are compared with rtol 1e-5, atol 1e-6 (the JAX twin of
the first test demands bit-equality and fails on the CPU for that reason).
"""
import threading

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
