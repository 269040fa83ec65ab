"""The port's in-process online loop (repro_torch: serving/feedback,
launch/cluster, launch/online) against the JAX package on the CPU.

Tolerance classes:
* bit-exact: ``ClickModel``'s labels and probabilities and
  ``FeedbackQueue``'s batches and counters, against the JAX copies from
  one seed (numpy on both sides);
* invariants: the closed loop itself. The thread interleaving decides
  which feedback batches train and when each flush reads, so a run checks
  the step count, ``feedback.put == served``, ``serving/requests ==
  served``, every table's ``stale_steps <= tau``, and predictions in
  (0, 1), not values.
"""
import dataclasses

import numpy as np
import pytest

from repro.data import ctr as jctr
from repro.launch import cluster as jcluster
from repro.serving import feedback as jfeedback

from repro_torch.data import ctr
from repro_torch.launch import cluster, online
from repro_torch.serving import (ClickModel, FeedbackQueue, ServingConfig,
                                 TrafficModel)

DS = ctr.CTRDataset("online", n_rows=3 * 40, n_fields=3, ids_per_field=3,
                    n_dense=4, n_tasks=2)


def _jds():
    return jctr.CTRDataset(**dataclasses.asdict(DS))


def _requests(n, seed=1):
    return [r for _, r in TrafficModel.for_dataset(DS, n_users=300)
            .requests(n, seed=seed)]


def test_click_model_labels_bit_equal_with_jax():
    reqs = _requests(40)
    for seed in (None, 7):
        t = ClickModel.for_dataset(DS, seed)
        j = jfeedback.ClickModel.for_dataset(_jds(), seed)
        got = np.stack([t.click(r) for r in reqs])
        want = np.stack([j.click(r) for r in reqs])
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    ids = np.stack([r["ids"] for r in reqs])
    dense = np.stack([r["dense"] for r in reqs])
    np.testing.assert_array_equal(t.prob(ids, dense), j.prob(ids, dense))


def test_feedback_queue_batches_bit_equal_with_jax():
    reqs = _requests(50, seed=2)
    labels = ClickModel.for_dataset(DS).truth.prob(
        np.stack([r["ids"] for r in reqs]),
        np.stack([r["dense"] for r in reqs])).astype(np.float32)
    t, j = FeedbackQueue(8, capacity=20), jfeedback.FeedbackQueue(
        8, capacity=20)
    for q in (t, j):
        q.put_many(reqs[:30], labels[:30])
    assert t.stats == j.stats == {"put": 30, "dropped": 10, "pending": 20}
    for _ in range(2):
        a, b = t.next_batch(0.01), j.next_batch(0.01)
        assert set(a) == set(b) == {"ids", "labels", "dense"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert t.next_batch(0.01) is None and j.next_batch(0.01) is None
    for q in (t, j):
        q.put_many(reqs[30:], labels[30:])
        q.close()
    a, b = t.next_batch(None), j.next_batch(None)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert t.stats == j.stats and len(t) == len(j)


def test_small_ctr_trainer_matches_jax():
    tt, tds = cluster.small_ctr_trainer(device="cpu")
    jt, jds = jcluster.small_ctr_trainer()
    assert tds.field_rows() == jds.field_rows()
    assert tt.collection.names == jt.collection.names
    for (n, s), (_, w) in zip(tt.collection.items(), jt.collection.items()):
        for f in ("rows", "dim", "backend", "cache_rows", "lr",
                  "staleness", "optimizer"):
            assert getattr(s, f) == getattr(w, f), (n, f)
    assert tt.mode.emb_staleness == jt.mode.emb_staleness == 2
    assert str(tt.device) == "cpu"


@pytest.mark.parametrize("backend,mode", [("host_lru", "hybrid"),
                                          ("dense", "sync")])
def test_run_online_in_process(backend, mode):
    """Port of ``tests/test_online_loop.py::test_run_online_in_process``
    (host_lru, hybrid(2)), plus a dense sync run."""
    res = online.run_online(steps=6, mode=mode, backend=backend, tau=2,
                            batch=8, max_batch=4, n_clients=2,
                            requests_per_client=12, n_users=500, seed=0,
                            device="cpu")
    assert res["steps"] == 6
    assert res["served"] == 24
    assert res["feedback"]["put"] == res["served"]
    assert res["feedback_batches"] + res["fallback_batches"] == 6
    sv = res["serving"]
    tau = 2 if mode == "hybrid" else 0
    for n in ("field_00", "field_01"):
        assert sv[f"serving/{n}/stale_steps"] <= tau
    assert sv["serving/requests"] == res["served"]
    assert sv["serving/errors"] == 0.0
    assert np.isfinite(res["loss_first"]) and np.isfinite(res["loss_last"])


def test_online_loop_returns_state_and_predictions():
    trainer, ds = cluster.small_ctr_trainer(backend="dense", device="cpu")
    summary, extras = online._online_loop(
        trainer, ds, steps=3, batch=8, config=ServingConfig(max_batch=4),
        n_clients=1, requests_per_client=10, n_users=200, seed=1)
    assert extras["state"].step == summary["steps"] == 3
    p = extras["preds"]
    assert p.shape == (10,) and np.all((p > 0) & (p < 1))


def test_online_main_on_cpu(capsys):
    res = online.main(["--steps", "3", "--batch", "8", "--clients", "1",
                       "--requests", "8", "--users", "200", "--backend",
                       "dense", "--device", "cpu"])
    assert res["steps"] == 3
    assert "online: 3 steps" in capsys.readouterr().out


def test_ps_processes_raise():
    with pytest.raises(NotImplementedError, match="multi-process PS"):
        online.run_online(steps=1, n_ps=1, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-process PS"):
        cluster.spawn_ps("/nonexistent", 0)
    with pytest.raises(NotImplementedError, match="multi-process PS"):
        cluster.run_cluster(steps=1)
    with pytest.raises(NotImplementedError, match="multi-process PS"):
        cluster.main([])
