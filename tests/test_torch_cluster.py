"""The port's multi-process launchers (repro_torch/launch/cluster.py and
``run_online(n_ps>0)``) with real PS subprocesses on the CPU
(``--device cpu``): a trainer + k ``python -m repro_torch.net.ps_server``
processes over the RPC wire, the kill-a-shard drill (SIGKILL one shard
mid-run, reshard its spooled rows onto the survivors, keep training), and
the online loop's invariants with its tables in PS processes.

Tolerance: invariants (the processes' and threads' timing decides which
batches train when): step counts, membership, zero lost rows, finite
losses, every served impression fed back, staleness <= tau. Every
spawned process is killed in the launchers' ``finally``."""
import os

import numpy as np
import pytest

from repro_torch.launch import cluster, online


def test_run_cluster_two_ps_processes(tmp_path):
    res = cluster.run_cluster(steps=5, n_ps=2, workdir=str(tmp_path),
                              device="cpu")
    assert res["steps"] == 5 and res["members"] == 2
    assert np.isfinite(res["loss"]) and res["steps_per_s"] > 0
    # a clean run never reshards
    assert not [e for e in res["events"] if e["kind"] == "reshard"]
    for i in range(2):
        assert os.path.isdir(tmp_path / f"ps{i}.spool")
        assert (tmp_path / f"ps{i}.port").read_text().strip().isdigit()


def test_run_cluster_kill_a_shard_reshards_onto_survivors(tmp_path):
    res = cluster.run_cluster(steps=10, n_ps=3, kill_shard=1, kill_at=4,
                              workdir=str(tmp_path), device="cpu")
    assert res["members"] == 2
    resh = [e for e in res["events"] if e["kind"] == "reshard"]
    assert resh and resh[0]["dead"] == [1] and resh[0]["k"] == 2
    # applied puts were spooled before their ack: the kill loses at most
    # in-flight work, never applied rows
    assert res["lost_rows"] and all(v == 0
                                    for v in res["lost_rows"].values())
    assert res["recovery_s"] is not None and res["recovery_s"] > 0
    assert np.isfinite(res["loss"])


def test_cluster_main_blocking_transport(tmp_path, capsys):
    res = cluster.main(["--steps", "3", "--ps", "2", "--backend", "dense",
                        "--transport", "blocking", "--workdir",
                        str(tmp_path), "--device", "cpu"])
    assert res["steps"] == 3 and res["members"] == 2
    assert "cluster: 3 steps" in capsys.readouterr().out


def test_ps_process_refuses_a_missing_gpu(tmp_path):
    """The PS process runs on the card by default: without a GPU it exits
    before publishing a port, and the launcher says so."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a GPU is visible: the default device exists")
    with pytest.raises(RuntimeError, match="before publishing"):
        cluster.spawn_cluster(str(tmp_path), 1, device="cuda")
    assert "no GPU" in (tmp_path / "ps0.log").read_text()


@pytest.mark.parametrize("backend,mode", [("host_lru", "hybrid"),
                                          ("dense", "sync")])
def test_run_online_over_ps_processes(backend, mode, tmp_path):
    """``run_online(n_ps=2)``: the invariants of
    ``test_run_online_in_process`` with the tables in 2 PS processes."""
    res = online.run_online(steps=6, mode=mode, backend=backend, tau=2,
                            batch=8, max_batch=4, n_clients=2,
                            requests_per_client=12, n_users=500, seed=0,
                            n_ps=2, workdir=str(tmp_path), device="cpu")
    assert res["steps"] == 6 and res["n_ps"] == 2
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
