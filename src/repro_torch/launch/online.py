"""Online-learning launcher: trainer + serving service over ONE embedding
state (port of ``repro/launch/online.py``, in process).

The paper's headline deployment (§1, §4): the recommender serves live
traffic while the trainer folds the resulting click feedback straight
back into the same embedding state — serve -> train -> serve, with the
hybrid algorithm's staleness bound as the consistency contract between
the two sides. This launcher runs that loop in one process:

* a trainer thread stepping the CTR model, preferring fresh feedback
  batches off the :class:`~repro_torch.serving.feedback.FeedbackQueue`
  and falling back to the offline sampler when serving has not produced
  a full batch yet (cold start);
* a :class:`~repro_torch.serving.service.ServingService` micro-batching
  concurrent client requests against the live ``StateCell``;
* closed-loop (or ``TrafficGenerator`` paced) client threads replaying
  Zipf traffic, labeling each served impression through the planted click
  model, and feeding it back.

The port's steps update the tables, accumulators, queues and dense
parameters in place, so the cell's lock is the whole consistency
contract: the trainer steps and publishes under it, and the service's
flush snapshots, reads, predicts and copies its predictions to the host
under it (``ServingService._flush_inner``). No read of the state happens
outside it; a flush sees the state between two steps, never inside one.

With ``--ps k`` the tables live in k embedding-PS processes
(``repro_torch.net.ps_server``, on the trainer's device) and the trainer
and the service reach them over the RPC wire: the trainer's prepares and
puts and the service's reads ride one pipelined connection per PS, and
each PS runs its ops in arrival order, so a read under the cell's lock
sees every put of the steps published before it.

Under a ``torch.distributed`` mesh of more than one rank (``utils.
set_mesh`` on every rank, as the JAX package runs under an ambient mesh)
every rank runs the loop: its own clients, its own feedback queue and a
service that takes turns with the trainer in one order on every rank
(``serving/service.py``'s module note). A step trains on the rank's block
of a global batch: the ranks of a data row each feed back ``batch /
ranks`` impressions, gathered along ``model``, or, where any rank has too
few, every rank takes its block of the offline sampler's next batch (the
choice agreed by the turn). Client ``c`` of rank ``r`` draws its requests
from seed ``seed + r * n_clients + c``. ``run_online(n_ps=k)`` starts the
PS processes from the mesh's first rank (``launch.cluster.mesh_cluster``),
which alone holds their connections.

Usage (on the card; ``--device cpu`` runs the plain versions)::

    PYTHONPATH=src python -m repro_torch.launch.online --steps 50 --clients 2
    PYTHONPATH=src python -m repro_torch.launch.online --steps 50 --ps 2
"""
from __future__ import annotations

import argparse
import tempfile
import threading
import time

import numpy as np

from repro_torch.launch.cluster import (mesh_cluster, small_ctr_trainer,
                                        spawn_cluster, stop_ps)
from repro_torch.serving import (ClickModel, FeedbackQueue, ServingConfig,
                                 ServingService, StateCell, TrafficGenerator,
                                 TrafficModel)
from repro_torch.serving.service import gather_row
from repro_torch.utils import get_mesh


def logloss(p: np.ndarray, y: np.ndarray) -> float:
    p = np.clip(np.asarray(p, np.float64), 1e-7, 1 - 1e-7)
    y = np.asarray(y, np.float64)
    return float(np.mean(-(y * np.log(p) + (1 - y) * np.log(1 - p))))


def _mean(xs) -> float:
    return float(np.nanmean(xs)) if len(xs) else float("nan")


def run_online(steps: int = 50, mode: str = "hybrid",
               backend: str = "host_lru", tau: int = 2, batch: int = 16,
               max_batch: int = 8, max_wait_ms: float = 2.0,
               n_clients: int = 2, requests_per_client: int = 64,
               qps: float = 0.0, n_users: int = 10_000, n_ps: int = 0,
               lossy: bool | None = None, seed: int = 0,
               workdir: str | None = None, spool_every: int = 1,
               device: str = "cuda") -> dict:
    """Run the closed serve->train->serve loop; returns a summary with
    trainer throughput, serving latency percentiles, the staleness
    gauges, and the served-traffic logloss trend (first half vs second
    half of impressions — online learning should bend it down).
    ``n_ps > 0`` puts the tables in that many PS processes (spawned in
    ``workdir``, on ``device``, spooling every ``spool_every`` applied
    puts; ``lossy`` selects the blockscale wire), killed when the loop
    ends. Under a mesh of more than one rank every rank calls it: the
    mesh's first rank starts the PS processes."""
    trainer, ds = small_ctr_trainer(mode=mode, backend=backend, tau=tau,
                                    seed=seed, device=device)
    members = []
    try:
        if n_ps > 0:
            from repro_torch.net.remote import connect_remote_backends
            kw = dict(spool_every=spool_every, device=str(trainer.device))
            workdir = workdir or tempfile.mkdtemp(prefix="online_ps_")
            if _spmd():
                members, eps = mesh_cluster(workdir, n_ps, **kw)
            else:
                members = spawn_cluster(workdir, n_ps, **kw)
                eps = [m.endpoint for m in members]
            connect_remote_backends(trainer, eps, lossy=lossy)
        summary, _ = _online_loop(
            trainer, ds, steps=steps, batch=batch,
            config=ServingConfig(max_batch=max_batch,
                                 max_wait_ms=max_wait_ms),
            n_clients=n_clients, requests_per_client=requests_per_client,
            qps=qps, n_users=n_users, seed=seed)
        summary["n_ps"] = n_ps
        return summary
    finally:
        # every rank's remote tables (the mesh's first rank alone holds
        # the connections and the PS processes)
        for b in trainer.backends.values():
            if b.remote:
                b.close()
        stop_ps(members)


def _spmd() -> bool:
    """A mesh of more than one rank is in scope."""
    mesh = get_mesh()
    return mesh is not None and mesh.n_ranks > 1


def _rank_block(batch: dict) -> dict:
    """This rank's block of a global batch (rows over the batch axes of
    the mesh in scope)."""
    import torch

    from repro_torch.sharding.partition import BATCH, P, local_block
    return {k: local_block(get_mesh(), P(BATCH), torch.from_numpy(
        np.ascontiguousarray(v))).numpy() for k, v in batch.items()}


def _online_loop(trainer, ds, *, steps: int, batch: int,
                 config: ServingConfig, n_clients: int,
                 requests_per_client: int, qps: float = 0.0,
                 n_users: int = 10_000, seed: int = 0, state=None,
                 feedback_wait_s: float = 0.05):
    """The loop of :func:`run_online` over a given CTR ``trainer`` and its
    dataset ``ds``: initialise from the sampler's first batch (or start
    from ``state``, the rank's blocks under a mesh), then train ``steps``
    steps on one thread while ``n_clients`` threads are served. Returns
    ``(summary, extras)``: ``extras`` holds the final ``state``, the
    served ``preds`` (n_served,) in arrival order, the loop's ``wall_s``,
    the service's ``turns`` (under a mesh) and ``fed_back`` (a step's
    batch was feedback, not the sampler's). A step waits up to
    ``feedback_wait_s`` for a feedback batch. Under a mesh of more than
    one rank every rank calls it (see the module note); ``batch`` is the
    global batch and must divide over the ranks."""
    spmd = _spmd()
    ranks = get_mesh().n_ranks if spmd else 1
    if batch % ranks:
        raise ValueError(f"batch {batch} does not divide over the mesh's "
                         f"{ranks} ranks")
    block = _rank_block if spmd else (lambda b: b)
    sampler = ds.sampler(batch, seed=seed)
    first = next(sampler)
    if state is None:
        state = trainer.init(seed, block(first))
    cell = StateCell(state, 0)

    traffic = TrafficModel.for_dataset(ds, n_users=n_users)
    click = ClickModel.for_dataset(ds)
    feedback = FeedbackQueue(batch_size=batch // ranks)
    svc = ServingService(trainer, cell, config)

    train_log = {"losses": [], "feedback_batches": 0,
                 "fallback_batches": 0, "fed_back": [], "state": state}

    def trainer_loop():
        # each step takes its turn (with no mesh: the cell's lock). It
        # trains on feedback when the rank's queue holds a batch after
        # waiting up to ``feedback_wait_s`` for one (under a mesh only if
        # every rank's does: the turn agrees on it, and the ranks of a
        # data row train on their shares side by side), else on its block
        # of the sampler's next batch
        s = state
        for t in range(steps):
            until = time.monotonic() + feedback_wait_s
            while len(feedback) < feedback.batch_size \
                    and time.monotonic() < until:
                time.sleep(1e-3)

            def step(use_feedback, t=t):
                nonlocal s
                fb = gather_row(feedback.next_batch(timeout=0))[0] \
                    if use_feedback else block(next(sampler))
                s, m = trainer.step(s, fb)
                cell.publish(s, t + 1)
                return m, use_feedback
            m, used = svc.train_turn(
                step, agree=len(feedback) >= feedback.batch_size)
            train_log["feedback_batches" if used
                      else "fallback_batches"] += 1
            train_log["fed_back"].append(used)
            train_log["losses"].append(float(m.get("loss", np.nan)))
        train_log["state"] = s

    base = seed + (get_mesh().rank * n_clients if spmd else 0)
    served = []                       # (pred, label) per impression
    served_lock = threading.Lock()

    def client_loop(cid: int):
        def serve_one(req):
            pred = svc.predict(req)
            label = click.click(req)
            feedback.put(req, label)
            with served_lock:
                served.append((float(pred[0]), float(label[0])))

        if qps > 0:
            gen = TrafficGenerator(traffic, qps=qps / max(n_clients, 1),
                                   seed=base + cid)
            gen.replay(requests_per_client, serve_one)
        else:
            # closed loop: serve the full quota as fast as replies come
            # back — the quota, not the trainer's finish line, bounds the
            # run, so `served` counts are deterministic however fast the
            # training side moves
            for _, req in traffic.requests(requests_per_client,
                                           seed=base + cid):
                serve_one(req)

    errors = []

    def guarded(fn, *args):
        try:
            fn(*args)
        except Exception as e:   # noqa: BLE001 -- re-raised below
            errors.append(e)

    svc.start()
    t0 = time.monotonic()
    threads = [threading.Thread(target=guarded, args=(trainer_loop,),
                                name="trainer")]
    threads += [threading.Thread(target=guarded, args=(client_loop, c),
                                 name=f"client{c}")
                for c in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    dt = time.monotonic() - t0
    svc.stop()
    if errors:
        raise errors[0]

    half = len(served) // 2
    p = np.asarray([s[0] for s in served], np.float64)
    y = np.asarray([s[1] for s in served], np.float64)
    losses = train_log["losses"]
    summary = {
        "steps": len(losses),
        "steps_per_s": len(losses) / max(dt, 1e-9),
        "loss_first": _mean(losses[: max(steps // 2, 1)]),
        "loss_last": _mean(losses[steps // 2:]),
        "feedback_batches": train_log["feedback_batches"],
        "fallback_batches": train_log["fallback_batches"],
        "served": len(served),
        "served_logloss_first": logloss(p[:half], y[:half])
        if half else float("nan"),
        "served_logloss_last": logloss(p[half:], y[half:])
        if half else float("nan"),
        "feedback": feedback.stats,
        "serving": svc.metrics(),
    }
    return summary, {"state": train_log["state"], "preds": p, "wall_s": dt,
                     "turns": svc.turn_counts(),
                     "fed_back": train_log["fed_back"]}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="closed-loop online learning: trainer + serving over "
                    "one embedding backend")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mode", default="hybrid",
                    choices=["sync", "hybrid", "async"])
    ap.add_argument("--backend", default="host_lru",
                    choices=["dense", "host_lru"])
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--batch", type=int, default=16,
                    help="training batch size (feedback batches match)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="serving micro-batch flush size")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="serving micro-batch latency budget")
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--requests", type=int, default=64,
                    help="requests per client thread")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="open-loop target QPS across clients "
                         "(0 = closed loop)")
    ap.add_argument("--users", type=int, default=10_000)
    ap.add_argument("--ps", type=int, default=0,
                    help="embedding-PS processes (0 = in-process backend)")
    ap.add_argument("--lossy", action="store_true", default=None,
                    help="blockscale-fp16 wire payloads (with --ps)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    res = run_online(steps=args.steps, mode=args.mode, backend=args.backend,
                     tau=args.tau, batch=args.batch,
                     max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                     n_clients=args.clients,
                     requests_per_client=args.requests, qps=args.qps,
                     n_users=args.users, n_ps=args.ps, lossy=args.lossy,
                     seed=args.seed, device=args.device)
    sv = res["serving"]
    print(f"online: {res['steps']} steps @ {res['steps_per_s']:.2f} "
          f"steps/s, {res['served']} impressions served "
          f"({res['feedback_batches']} feedback / "
          f"{res['fallback_batches']} fallback batches)")
    print(f"  train loss {res['loss_first']:.4f} -> {res['loss_last']:.4f}")
    print(f"  served logloss {res['served_logloss_first']:.4f} -> "
          f"{res['served_logloss_last']:.4f}")
    print(f"  serving p50 {sv['serving/p50_ms']:.2f}ms "
          f"p99 {sv['serving/p99_ms']:.2f}ms qps {sv['serving/qps']:.1f}")
    stale = {k.split("/")[1]: v for k, v in sv.items()
             if k.endswith("/stale_steps")}
    print(f"  staleness gauges: {stale}")
    return res


if __name__ == "__main__":
    main()
