"""The port's ``ServingService`` and online loop under a ``torch.distributed``
mesh: one turn order on every rank, the serial trajectory, the pooled rows
against one process, the predictions against JAX, the closed loop's
invariants and a failure raised on every rank.

One world of 4 gloo processes (a (data 2, model 2) mesh, ``file://``
rendezvous in tmp_path) runs every part once (``WORLD``); each test reads
its part. For each table kind of ``CELLS`` (dense, host_lru with a
replicated and with a row-sharded cache, the router over 2 dense shards,
a dense table on one PS process that the fixture starts through
``launch/cluster.py``) the world restores one JAX checkpoint and:

* the trajectory: a service with 2 reader threads a rank beside a trainer
  thread that takes ``STEPS`` hybrid(2) steps through ``train_turn`` (each
  after a flush has read the step before it); every flush records the
  published step, the block it read and its pooled rows; then a last
  round of requests at the final step;
* the serial run: the same mesh, a second trainer from the same
  checkpoint, no service: it trains the same batches and reads, at each
  step, every block a flush read there;
* the closed loop: ``launch.online._online_loop`` for ``LOOP`` steps from
  the trajectory's final state, 2 closed-loop clients a rank feeding back
  ``LOOP`` shares of the global batch, so that every step waits for and
  trains on feedback (the ranks of a data row on their shares side by
  side); each step's batch and loss recorded.

``run_online(n_ps=1)`` runs under the mesh (the mesh's first rank starts
the PS process), and a service whose flush raises on rank 1 ends the
world's parts.

Tolerance classes:
* bit for bit: every flush's pooled rows against the serial run's read of
  the same block at the same step; the final states (tables, caches,
  queues, dense parameters), losses, LRU counters, slot maps and host
  stores of the trajectory against the serial run; the final flushes'
  pooled rows against one port process's read of the same state (the
  mesh's checkpoint) and the same blocks side by side;
* against JAX with no mesh on the global batches (the serial run's class
  in ``tests/test_torch_mesh_emb.py``: the mesh's puts add the ranks' sums
  in another order): losses rtol 1e-5, tables rtol 1e-5 / atol 1e-6,
  accumulators atol 1e-9, slot ids, LRU counters and slot maps equal;
  the final round's predictions against JAX's ``ServingService`` on the
  same state rtol 1e-5 / atol 1e-6 (``tests/test_torch_serving.py``'s
  class: a flush runs the FFNN at another GEMM shape);
* the closed loop's steps, all on feedback, against one port process
  with no mesh training the data rows' recorded blocks side by side from
  the loop's start (the trajectory's checkpoint): ``_hold_serial``'s
  class (losses rtol 1e-5, tables rtol 1e-5 / atol 1e-6);
* invariants where threads decide the order (the closed loop): on every
  rank the steps asked for, ``feedback.put == served``,
  ``serving/requests == served``, no errors, ``stale_steps <= tau``; the
  flush count, the turns and the feedback or fallback choices equal on
  every rank; every rank's slot maps and counters equal;
* the failure: every rank raises ``ServingMeshError`` naming the rank
  whose flush raised, within the test's bound.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import adapters as jadapters
from repro.core import backend as jbackend
from repro.core import hybrid as jhybrid
from repro.data import ctr as jctr
from repro.optim import optimizers as jopt
from repro.serving import ServingConfig as JServingConfig
from repro.serving import ServingService as JServingService
from repro.serving import StateCell as JStateCell

from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapters
from repro_torch.core import backend as BK
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.data.ctr import CTRDataset
from repro_torch.launch.cluster import spawn_cluster, stop_ps
from repro_torch.optim.optimizers import OptConfig

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
N_RANKS = 4
CTR_KW = dict(name="mo", arch_type="recsys", n_id_fields=3, ids_per_field=2,
              emb_dim=8, emb_rows=192, n_dense_features=4, mlp_dims=(16,),
              n_tasks=1)
DS_KW = dict(name="mo", n_rows=192, n_fields=3, ids_per_field=2, n_dense=4)
BATCH, EMB_LR, DENSE_LR, TAU = 32, 5e-2, 5e-3, 2
# JAX steps before its checkpoint; the trajectory's steps; the closed
# loop's (tau + 2: its last steps apply puts of its own); the flushes'
# rows a rank (the ranks of a data row read 2 x MAX_BATCH)
PRE, STEPS, LOOP, MAX_BATCH = 2, 3, TAU + 2, 4
# the closed loop's requests a client: 2 clients a rank feed back LOOP
# shares of BATCH / N_RANKS impressions; a step waits up to FEEDBACK_WAIT_S
# for its share (a bound never reached: the clients always bring it)
LOOP_REQUESTS, FEEDBACK_WAIT_S = LOOP * BATCH // N_RANKS // 2, 30.0
FAIL_TIMEOUT_S = 6.0          # the failure case's request timeout
_T = ("field_00", "field_01", "field_02")
# {table: (backend, cache_rows, spec fields)}; a batch reads about 22 of a
# table's 64 rows: 32 slots (8 a rank: row-sharded) and 34 (replicated)
# evict; the router's 2 dense shards hold 32 rows each
CELLS = {
    "dense": dict.fromkeys(_T, ("dense", 0, {})),
    "lru_replicated": dict.fromkeys(_T, ("host_lru", 34, {})),
    "lru_sharded": dict.fromkeys(_T, ("host_lru", 32, {})),
    "router": dict.fromkeys(_T, ("dense", 0, {"emb_shards": 2})),
    "remote": dict.fromkeys(_T, ("dense", 0, {})),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _batches():
    it = CTRDataset(**DS_KW).sampler(BATCH, seed=5)
    return [next(it) for _ in range(PRE + STEPS)]


def _specs(coll, cell):
    def one(n, sp):
        name, cache, kw = CELLS[cell][n]
        return dataclasses.replace(sp, backend=name, cache_rows=cache, **kw)
    return coll.map_specs(one)


def _jax_trainer(cell):
    jcfg = JModelConfig(**CTR_KW)
    rows = jctr.CTRDataset(**DS_KW).field_rows()
    coll = _specs(jadapters.ctr_collection(jcfg, lr=EMB_LR, field_rows=rows),
                  cell)
    return jhybrid.PersiaTrainer(
        jadapters.recsys_adapter(jcfg, field_rows=rows, collection=coll),
        jhybrid.TrainMode.hybrid(TAU), jopt.OptConfig(kind="adam",
                                                      lr=DENSE_LR))


def _port_trainer(cell):
    cfg = ModelConfig(**CTR_KW)
    rows = CTRDataset(**DS_KW).field_rows()
    coll = _specs(adapters.ctr_collection(cfg, lr=EMB_LR, field_rows=rows),
                  cell)
    return PersiaTrainer(
        adapters.recsys_adapter(cfg, field_rows=rows, collection=coll),
        TrainMode.hybrid(TAU), OptConfig(kind="adam", lr=DENSE_LR),
        device="cpu")


WORLD = textwrap.dedent("""
    import dataclasses, datetime, pickle, sys, threading, time
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, n, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    from repro_torch.core import adapters
    from repro_torch.core import backend as BK
    from repro_torch.core.hybrid import PersiaTrainer
    from repro_torch.data.ctr import CTRDataset
    from repro_torch.launch import online
    from repro_torch.net import connect_remote_backends
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.serving import (ServingConfig, ServingService,
                                     StateCell, TrafficModel)
    from repro_torch.serving.service import ServingMeshError
    from repro_torch.sharding import partition as SP
    from repro_torch.utils import Mesh, get_mesh, set_mesh

    with open(f"{work}/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    C = inp["cfg"]
    DS = CTRDataset(**C["ds"])

    def trainer(cell, ps=None):
        def one(name, sp):
            b, cache, kw = C["cells"][cell][name]
            return dataclasses.replace(sp, backend=b, cache_rows=cache, **kw)
        coll = adapters.ctr_collection(
            C["ctr"], lr=C["lr"][0], field_rows=C["rows"]).map_specs(one)
        tr = PersiaTrainer(
            adapters.recsys_adapter(C["ctr"], field_rows=C["rows"],
                                    collection=coll),
            C["mode"], OptConfig(kind="adam", lr=C["lr"][1]), device="cpu")
        if ps is not None:
            connect_remote_backends(tr, ps)
        return tr

    def start(cell, ps=None):
        tr = trainer(cell, ps)
        if ps is not None:                  # the PS draws, then restores
            tr.init(seed=0, batch_example=run[0])
        return tr, tr.restore(inp["jax_ckpt"][cell])

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().numpy()
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(host(v) for v in x)
        return x

    def glob(tr, s):
        g = tr.global_state(s)
        out = host({"emb": g.emb, "queue": g.emb_queue, "dense": g.dense,
                    "opt": g.opt})
        if rank == 0 and any(b.remote for b in tr.backends.values()):
            # a remote table's rows live in its PS process
            out["blobs"] = {name: b.state_for_checkpoint(g.emb[name])
                            for name, b in tr.backends.items()}
        return out

    def counters(tr):
        out = {}
        for name, b in tr.backends.items():
            b = BK.unwrap(b)
            for k, sub in enumerate(getattr(b, "shard_backends", None)
                                    or [b]):
                if hasattr(sub, "_id_for_slot"):
                    out[name if sub is b else f"{name}/s{k}"] = {
                        "counts": (sub.faults, sub.writebacks, sub.hits,
                                   sub.admits),
                        "id_for_slot": sub._id_for_slot.copy(),
                        "store": sub.store.serialize()}
        return out

    def same(a, b):
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y)
                                            for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        return a == b

    reqs = [r for _, r in TrafficModel.for_dataset(DS, n_users=300)
            .requests(64, seed=100 + rank)]

    def trajectory(cell, ps):
        tr, s = start(cell, ps[0] if ps else None)
        sc = StateCell(s, 0)
        svc = ServingService(tr, sc, ServingConfig(
            max_batch=C["max_batch"], max_wait_ms=1.0))
        flushes, real = [], tr.serve_lookup

        def recording(state, batch):
            pooled, info = real(state, batch)
            flushes.append((sc.step, {k: np.array(v)
                                      for k, v in batch.items()},
                            host(pooled)))
            return pooled, info
        tr.serve_lookup = recording
        svc.start()
        done, losses, out, errors = threading.Event(), [], {}, []
        groups = []         # a step's groups: the mesh's, not the fork's

        def train():
            st = sc.snapshot()[0]
            for t in range(C["steps"]):
                while not any(f[0] == t for f in flushes):
                    time.sleep(1e-3)

                def fn(agreed, t=t):
                    nonlocal st
                    groups.append(get_mesh() is mesh)
                    st, m = tr.step(st, run[t])
                    sc.publish(st, t + 1)
                    return float(m["loss"])
                losses.append(svc.train_turn(fn))
            out["state"] = st

        def reader(i):
            k = 0
            while not done.is_set():
                svc.predict(reqs[(2 * k + i) % len(reqs)])
                k += 1

        def guarded(fn, *a):
            try:
                fn(*a)
            except BaseException as e:
                errors.append(repr(e))
        threads = [threading.Thread(target=guarded, args=(train,))] + [
            threading.Thread(target=guarded, args=(reader, i))
            for i in range(2)]
        for th in threads:
            th.start()
        threads[0].join()
        while not any(f[0] == C["steps"] for f in flushes) and not errors:
            time.sleep(1e-3)
        done.set()
        for th in threads[1:]:
            th.join()
        n_before = len(flushes)
        final_reqs = reqs[rank * 3:rank * 3 + 3]
        final = svc.predict_many(final_reqs)
        svc.stop()
        del tr.serve_lookup
        st = out["state"]
        rec = {"losses": losses, "errors": errors, "flushes": flushes,
               "final_flushes": list(range(n_before, len(flushes))),
               "final_reqs": final_reqs, "final_preds": final,
               "turns": svc.turn_counts(), "step_groups": groups,
               "metrics": svc.metrics(), "state": glob(tr, st),
               "counters": counters(tr)}
        tr.save(f"{work}/ckpt_{cell}", st)
        rec["ckpt"] = f"{work}/ckpt_{cell}"
        return tr, st, rec

    def serial(cell, ps, flushes):
        tr, s = start(cell, ps[1] if ps else None)
        losses, reads, off = [], 0, []
        for t in range(C["steps"] + 1):
            for i, (at, block, pooled) in enumerate(flushes):
                if at != t:
                    continue
                got, _ = tr.serve_lookup(s, block)
                reads += 1
                if not same(host(got), pooled):
                    off.append(i)
            if t < C["steps"]:
                s, m = tr.step(s, run[t])
                losses.append(float(m["loss"]))
        rec = {"losses": losses, "reads": reads, "off": off,
               "state": glob(tr, s), "counters": counters(tr)}
        for b in tr.backends.values():
            if b.remote:
                b.close()
        return rec

    def closed_loop(tr, st):
        real, trained = tr.step, []

        def recording(state, batch):
            state, m = real(state, batch)
            trained.append(({k: np.array(v) for k, v in batch.items()},
                            float(m["loss"])))
            return state, m
        tr.step = recording
        # each rank's feedback share, before the row gathers it
        real_gather, shares = online.gather_row, []

        def sharing(batch):
            shares.append({k: np.array(v) for k, v in batch.items()})
            return real_gather(batch)
        online.gather_row = sharing
        summary, extras = online._online_loop(
            tr, DS, steps=C["loop"], batch=C["batch"],
            config=ServingConfig(max_batch=C["max_batch"], max_wait_ms=1.0),
            n_clients=2, requests_per_client=C["loop_requests"],
            n_users=300, seed=1, state=st,
            feedback_wait_s=C["feedback_wait"])
        del tr.step
        online.gather_row = real_gather
        summary["shares"] = shares
        summary["turns"] = extras["turns"]
        summary["fed_back"] = extras["fed_back"]
        summary["trained"] = trained
        summary["counters"] = counters(tr)
        summary["state"] = glob(tr, extras["state"])
        return summary

    def failure():
        tr, s = start("dense")
        svc = ServingService(tr, StateCell(s, 0), ServingConfig(
            max_batch=C["max_batch"], max_wait_ms=1.0,
            timeout_s=C["fail_timeout"]))
        real, calls = tr.serve_lookup, []

        def flaky(state, batch):
            calls.append(1)
            if rank == 1 and len(calls) == 2:
                raise RuntimeError("injected read failure")
            return real(state, batch)
        tr.serve_lookup = flaky
        raised = []

        def steps():
            st = s
            for t in range(200):          # until the failure ends it
                def fn(agreed, t=t):
                    nonlocal st
                    st, _ = tr.step(st, run[t % len(run)])
                    return agreed
                svc.train_turn(fn)

        def client():
            for r in reqs:
                svc.predict(r)

        def guarded(fn, what):
            try:
                fn()
            except ServingMeshError as e:
                raised.append((what, "ServingMeshError", str(e)))
            except BaseException as e:
                raised.append((what, type(e).__name__, str(e)))
        t0 = time.monotonic()
        svc.start()
        threads = [threading.Thread(target=guarded, args=(steps, "step"))]
        threads += [threading.Thread(target=guarded, args=(client, "client"))
                    for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        guarded(svc.stop, "stop")
        return {"raised": raised, "s": time.monotonic() - t0,
                "alive": [th.is_alive() for th in threads]}

    dist.init_process_group("gloo", init_method=f"file://{work}/rdzv",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=90))
    mesh = Mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    with set_mesh(mesh):
        bat = lambda b: {k: SP.local_block(mesh, SP.P(SP.BATCH),
                                           torch.as_tensor(np.asarray(v)))
                         .numpy() for k, v in b.items()}
        run = [bat(b) for b in inp["batches"][C["pre"]:]]
        for cell in C["cells"]:
            ps = inp["ps"] if cell == "remote" else None
            t0 = time.monotonic()
            tr, st, traj = trajectory(cell, ps)
            out[cell] = {"trajectory": traj,
                         "serial": serial(cell, ps, traj["flushes"])}
            out[cell]["loop"] = closed_loop(tr, st)
            out[cell]["s"] = time.monotonic() - t0
            for b in tr.backends.values():
                if b.remote:
                    b.close()
        t0 = time.monotonic()
        res = online.run_online(
            steps=C["loop"], mode="hybrid", backend="dense", tau=2,
            batch=C["batch"], max_batch=C["max_batch"], n_clients=2,
            requests_per_client=12, n_users=300, n_ps=1, seed=0,
            workdir=f"{work}/run_online_ps", spool_every=0, device="cpu")
        res["s"] = time.monotonic() - t0
        out["run_online_ps"] = res
        out["failure"] = failure()
    dist.barrier()
    with open(f"{work}/rank{rank}.pkl", "wb") as f:
        pickle.dump(host(out), f)
    dist.destroy_process_group()
    print("RANK_OK", rank)
""")


def _jax_inputs(work) -> tuple[dict, object]:
    """Each cell's JAX checkpoint after PRE steps (the remote cell's
    after none; the world restores it) and a function computing the
    oracles: JAX's next STEPS steps with no mesh on the global batches."""
    batches, ckpts, runs = _batches(), {}, {}
    for cell in CELLS:
        jt = _jax_trainer(cell)
        js = jt.init(jax.random.PRNGKey(1), _jnp(batches[0]))
        # a remote table restores its rows, not its PS's staleness queue:
        # its checkpoint is taken before any put is queued
        for b in batches[:PRE if cell != "remote" else 0]:
            js, _ = jt.step(js, _jnp(b))
        ckpts[cell] = str(work / f"jax_{cell}")
        jt.save(ckpts[cell], js)
        runs[cell] = (jt, js)

    def oracle():
        out = {}
        for cell, (jt, js) in runs.items():
            losses = []
            for b in batches[PRE:]:
                js, m = jt.step(js, _jnp(b))
                losses.append(float(m["loss"]))
            out[cell] = {"losses": losses, "emb": _np(js.emb),
                         "dense": _np(js.dense),
                         "counters": _counters(jt.backends),
                         "blobs": {n: _np(jbackend.unwrap(b)
                                          .state_for_checkpoint(js.emb[n]))
                                   for n, b in jt.backends.items()}}
        return out
    return ckpts, oracle


def _counters(backends) -> dict:
    out = {}
    for n, b in backends.items():
        b = jbackend.unwrap(b)
        if hasattr(b, "_id_for_slot"):
            out[n] = {"counts": (b.faults, b.writebacks, b.hits, b.admits),
                      "id_for_slot": np.asarray(b._id_for_slot).copy()}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Runs the world once for the module: ``{"ranks": [rank result],
    "oracle": JAX's runs, "inputs": the world's inputs}``."""
    work = tmp_path_factory.mktemp("mesh_online")
    members = []
    try:
        # the remote cell's PS processes: the trajectory's and the serial
        # run's (run_online starts its own from the mesh's first rank)
        members = spawn_cluster(str(work / "ps"), 2, spool_every=0,
                                device="cpu")
        eps = [("127.0.0.1", m.port) for m in members]
        ckpts, oracle = _jax_inputs(work)
        inp = {"cfg": {"ctr": ModelConfig(**CTR_KW), "ds": DS_KW,
                       "rows": CTRDataset(**DS_KW).field_rows(),
                       "lr": (EMB_LR, DENSE_LR), "mode": TrainMode.hybrid(TAU),
                       "cells": CELLS, "pre": PRE, "steps": STEPS,
                       "loop": LOOP, "batch": BATCH, "max_batch": MAX_BATCH,
                       "loop_requests": LOOP_REQUESTS,
                       "feedback_wait": FEEDBACK_WAIT_S,
                       "fail_timeout": FAIL_TIMEOUT_S},
               "batches": _batches(), "jax_ckpt": ckpts,
               "ps": [[e] for e in eps]}
        with open(work / "inputs.pkl", "wb") as f:
            pickle.dump(inp, f)
        (work / "world.py").write_text(WORLD)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([str(SRC),
                                             env.get("PYTHONPATH", "")])
        procs = [subprocess.Popen(
            [sys.executable, str(work / "world.py"), str(r), str(N_RANKS),
             str(work)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(N_RANKS)]
        ora = oracle()
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=240)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        stop_ps(members)
    for r, log in enumerate(logs):
        assert f"RANK_OK {r}" in log, f"rank {r}:\n{log[-4000:]}"
    ranks = []
    for r in range(N_RANKS):
        with open(work / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "oracle": ora, "inputs": inp}


def _close(got, want, atol, what, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _leaves(tree, path=""):
    """{path: array} of a tree of dicts (a router's tables shard by
    shard)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}/{i}"))
        return out
    return {path: np.asarray(tree)}


def _equal(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), (what, sorted(set(g) ^ set(w)))
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, \
            (what, k)
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what}{k}")


@pytest.mark.parametrize("cell", list(CELLS))
def test_one_turn_order_on_every_rank(world, cell):
    """The trajectory's service and trainer take the same turns on every
    rank: the same ticks, flushes and train turns, every flush at the same
    published step, blocks of one shape (``MAX_BATCH`` rows a rank, the
    ``model`` ranks of a data row reading their blocks side by side), the
    same ``serving/batches``; every request answered, no thread raised."""
    trs = [r[cell]["trajectory"] for r in world["ranks"]]
    t0 = trs[0]
    assert not t0["errors"], t0["errors"]
    assert t0["turns"]["step"] == STEPS and t0["turns"]["flush"] >= STEPS + 1
    for tr in trs:
        assert not tr["errors"], tr["errors"]
        assert tr["turns"]["flush"] == t0["turns"]["flush"]
        assert tr["turns"]["step"] == t0["turns"]["step"]
        assert [f[0] for f in tr["flushes"]] == [f[0] for f in t0["flushes"]]
        assert tr["metrics"]["serving/batches"] == t0["turns"]["flush"]
        assert tr["metrics"]["serving/errors"] == 0.0
        assert tr["losses"] == t0["losses"]
        for _, block, _ in tr["flushes"]:
            assert block["ids"].shape == (2 * MAX_BATCH, 3, 2)
    # the model ranks of a data row read one block; the data rows differ
    for a, b in ((0, 1), (2, 3)):
        for fa, fb in zip(trs[a]["flushes"], trs[b]["flushes"]):
            np.testing.assert_array_equal(fa[1]["ids"], fb[1]["ids"])
    assert {s for s, _, _ in t0["flushes"]} == set(range(STEPS + 1))


@pytest.mark.parametrize("cell", list(CELLS))
def test_train_turns_run_on_the_trainers_groups(world, cell):
    """A train turn runs the step on the groups of the trainer's thread
    (the mesh's, with the trainer's timeout), not on the service's fork,
    whose groups time out at half the request timeout: every step of the
    trajectory on every rank saw the mesh itself in scope."""
    for r in world["ranks"]:
        assert r[cell]["trajectory"]["step_groups"] == [True] * STEPS


@pytest.mark.parametrize("cell", list(CELLS))
def test_flushes_see_the_serial_trajectory(world, cell):
    """Every flush, made under the cell's lock at published step t, reads
    bit for bit the pooled rows the same mesh reads at step t when it
    trains the same batches with no service beside it; the reader never
    perturbs the trajectory: losses, the final state (tables, caches,
    queues, dense parameters, Adam moments), LRU counters, slot maps and
    host stores equal the serial run's on every rank."""
    for r in world["ranks"]:
        tr, se = r[cell]["trajectory"], r[cell]["serial"]
        assert se["reads"] == len(tr["flushes"]) > STEPS
        assert se["off"] == [], f"flushes {se['off'][:5]} left the serial run"
        assert tr["losses"] == se["losses"]
        _equal(tr["state"], se["state"], f"{cell} state")
        _equal(tr["counters"], se["counters"], f"{cell} counters")


def _hold_serial(ranks, cell, ref, extract, coll):
    """The serial run under the mesh (rank 0's joined state; every rank's
    counters) against a run with no mesh (``ref``: losses, global tables,
    dense parameters, LRU counters, checkpoint blobs; ``extract`` reads a
    blob of ``ref`` by the specs of ``coll``): losses rtol 1e-5, tables
    rtol 1e-5 / atol 1e-6, accumulators atol 1e-9, slot ids, counters and
    slot maps equal, dense parameters rtol 1e-5 / atol 1e-6; a remote
    table's rows off its PS's checkpoint."""
    got = ranks[0][cell]["serial"]
    _close(got["losses"], ref["losses"], 0, "losses", rtol=1e-5)
    want, mine = _leaves(ref["emb"]), _leaves(got["state"]["emb"])
    if cell == "remote":      # the PS's rows, logical rows
        specs = _port_trainer(cell).collection
        want, mine = {}, {}
        for n, blob in got["state"]["blobs"].items():
            for i, (x, y) in enumerate(zip(
                    BK.extract_logical_rows(blob, specs[n], "dense"),
                    extract(ref["blobs"][n], coll[n], "dense"))):
                mine[f"{n}/{'acc' if i else 'table'}"] = x
                want[f"{n}/{'acc' if i else 'table'}"] = y
    assert set(mine) == set(want), (sorted(mine), sorted(want))
    for k, w in want.items():
        if k.endswith("slot_ids"):
            np.testing.assert_array_equal(mine[k], w, err_msg=k)
        elif k.endswith("acc"):
            _close(mine[k], w, 1e-9, k, 1e-5)
        else:
            _close(mine[k], w, 1e-6, k, 1e-5)
    for r in ranks:
        rc = r[cell]["serial"]["counters"]
        assert set(rc) == set(ref["counters"])
        for n, c in ref["counters"].items():
            assert rc[n]["counts"] == c["counts"], (n, rc[n]["counts"])
            np.testing.assert_array_equal(rc[n]["id_for_slot"],
                                          c["id_for_slot"])
    for a, b in zip(jax.tree.leaves(got["state"]["dense"]),
                    jax.tree.leaves(ref["dense"])):
        _close(a, b, 1e-6, "dense", 1e-5)


@pytest.mark.parametrize("cell", list(CELLS))
def test_serial_mesh_run_matches_jax(world, cell):
    """The serial run under the mesh against JAX with no mesh on the
    global batches from the same checkpoint, in ``_hold_serial``'s
    class."""
    _hold_serial(world["ranks"], cell, world["oracle"][cell],
                 jbackend.extract_logical_rows, _jax_trainer(cell).collection)


@pytest.mark.parametrize("cell", list(CELLS))
def test_serial_mesh_run_matches_one_process(world, cell):
    """The serial run under the mesh against one port process with no
    mesh (in process: the remote cell's tables are its dense tables)
    restoring the same JAX checkpoint and training the global batches,
    in ``_hold_serial``'s class (the mesh's puts add the ranks' sums in
    another order)."""
    tt = _port_trainer(cell)
    ts = tt.restore(world["inputs"]["jax_ckpt"][cell])
    losses = []
    for b in world["inputs"]["batches"][PRE:]:
        ts, m = tt.step(ts, b)
        losses.append(float(m["loss"]))
    tree = convert.state_to_numpy(ts)
    counters = {}
    for n, b in tt.backends.items():
        b = BK.unwrap(b)
        if hasattr(b, "_id_for_slot"):
            counters[n] = {"counts": (b.faults, b.writebacks, b.hits,
                                      b.admits),
                           "id_for_slot": np.asarray(b._id_for_slot)}
    ref = {"losses": losses, "emb": tree["emb"], "dense": tree["dense"],
           "counters": counters,
           "blobs": {n: BK.unwrap(b).state_for_checkpoint(ts.emb[n])
                     for n, b in tt.backends.items()}}
    _hold_serial(world["ranks"], cell, ref, BK.extract_logical_rows,
                 tt.collection)


def _final_blocks(world, cell):
    """The final round's flushes (at the last published step): for each,
    the global block (the data rows' blocks side by side, from the first
    rank of each row) and the pooled rows every rank read."""
    ranks = [r[cell]["trajectory"] for r in world["ranks"]]
    out = []
    for f in ranks[0]["final_flushes"]:
        assert all(r["flushes"][f][0] == STEPS for r in ranks)
        rows = (ranks[0]["flushes"][f], ranks[2]["flushes"][f])
        block = {k: np.concatenate([x[1][k] for x in rows])
                 for k in rows[0][1]}
        pooled = {n: np.concatenate([x[2][n] for x in rows])
                  for n in rows[0][2]}
        out.append((block, pooled))
    return out


@pytest.mark.parametrize("cell", list(CELLS))
def test_pooled_rows_and_predictions_against_one_process_and_jax(world,
                                                                 cell):
    """The mesh's final state (its checkpoint, saved under the mesh) read
    by one port process with no mesh: the final round's flushes' pooled
    rows equal its read of the same blocks side by side, bit for bit; and
    every rank's final predictions equal JAX's ``ServingService`` with no
    mesh on that state within rtol 1e-5 / atol 1e-6."""
    ranks = world["ranks"]
    ck = ranks[0][cell]["trajectory"]["ckpt"]
    tt = _port_trainer(cell)
    ts = tt.restore(ck)
    finals = _final_blocks(world, cell)
    assert finals
    for block, pooled in finals:
        got, _ = tt.serve_lookup(ts, block)
        for n, want in pooled.items():
            np.testing.assert_array_equal(want, got[n].numpy(), err_msg=n)
    jt = _jax_trainer(cell)
    js = jt.restore(ck)
    with JServingService(jt, JStateCell(js, 0),
                         JServingConfig(MAX_BATCH, 20.0)) as jsvc:
        for r in ranks:
            tr = r[cell]["trajectory"]
            want = jsvc.predict_many(tr["final_reqs"])
            _close(tr["final_preds"], want, 1e-6, cell, rtol=1e-5)


@pytest.mark.parametrize("cell", list(CELLS))
def test_closed_loop_invariants_on_every_rank(world, cell):
    """``_online_loop`` under the mesh for tau + 2 steps from the
    trajectory's state, 2 closed-loop clients a rank: on every rank the
    steps asked for, every one on feedback, every impression fed back and
    served, no error, ``stale_steps <= tau``, predictions in (0, 1); the
    flushes, turns and feedback / fallback choices equal on every rank;
    flushes padded (a closed loop of 2 clients holds at most 2 requests a
    rank); the LRU slot maps and counters equal on every rank."""
    loops = [r[cell]["loop"] for r in world["ranks"]]
    first = loops[0]
    for lp in loops:
        sv = lp["serving"]
        assert lp["steps"] == LOOP
        assert lp["served"] == 2 * LOOP_REQUESTS
        assert lp["fed_back"] == [True] * LOOP
        assert lp["feedback"]["put"] == lp["served"]
        assert sv["serving/requests"] == lp["served"]
        assert sv["serving/errors"] == 0.0
        for n in _T:
            assert sv[f"serving/{n}/stale_steps"] <= TAU
            assert sv[f"serving/{n}/batch_fill"] < 1.0
        assert sv["serving/batches"] == first["serving"]["serving/batches"]
        assert lp["turns"] == first["turns"]
        assert lp["turns"]["step"] == LOOP
        assert (lp["feedback_batches"], lp["fallback_batches"]) == \
            (first["feedback_batches"], first["fallback_batches"])
        assert lp["feedback_batches"] + lp["fallback_batches"] == LOOP
        assert np.isfinite(lp["loss_first"]) and np.isfinite(lp["loss_last"])
        _equal(lp["counters"], first["counters"], f"{cell} counters")


def test_closed_loop_feedback_steps_match_one_process(world):
    """The dense cell's closed loop under the mesh, every step on
    feedback: each step's block on every rank is its data row's feedback
    shares side by side (each rank's share as its queue gave it, before
    the gather along ``model``), bit for bit; one port process with no
    mesh restores the loop's start (the trajectory's checkpoint) and
    trains, at each step, the four ranks' shares side by side: losses and
    the final tables and dense parameters in ``_hold_serial``'s class."""
    cell = "dense"
    loops = [r[cell]["loop"] for r in world["ranks"]]
    assert all(lp["fed_back"] == [True] * LOOP for lp in loops)
    tt = _port_trainer(cell)
    ts = tt.restore(world["ranks"][0][cell]["trajectory"]["ckpt"])
    losses = []
    for t in range(LOOP):
        shares = [lp["shares"][t] for lp in loops]
        assert all(len(x["ids"]) == BATCH // N_RANKS for x in shares)

        def side_by_side(parts):
            return {k: np.concatenate([x[k] for x in parts])
                    for k in parts[0]}
        for r, lp in enumerate(loops):
            row = 2 * (r // 2)
            _equal(lp["trained"][t][0], side_by_side(shares[row:row + 2]),
                   f"step {t} rank {r}")
        ts, m = tt.step(ts, side_by_side(shares))
        losses.append(float(m["loss"]))
    tree = convert.state_to_numpy(ts)
    got = [{cell: {"serial": {"losses": [x[1] for x in lp["trained"]],
                              "state": lp["state"],
                              "counters": lp["counters"]}}}
           for lp in loops]
    _hold_serial(got, cell, {"losses": losses, "emb": tree["emb"],
                             "dense": tree["dense"], "counters": {}},
                 BK.extract_logical_rows, tt.collection)


def test_run_online_with_a_ps_under_the_mesh(world):
    """``run_online(n_ps=1)`` under the mesh: the mesh's first rank starts
    the PS process through ``launch.cluster.mesh_cluster`` and alone holds
    its connection; every rank runs the loop with its invariants, the same
    flushes and the same choices."""
    runs = [r["run_online_ps"] for r in world["ranks"]]
    for res in runs:
        sv = res["serving"]
        assert res["steps"] == LOOP and res["n_ps"] == 1
        assert res["served"] == 24 == res["feedback"]["put"]
        assert sv["serving/requests"] == 24 and sv["serving/errors"] == 0.0
        assert all(sv[f"serving/field_0{i}/stale_steps"] <= 2
                   for i in range(2))
        assert sv["serving/batches"] == runs[0]["serving"]["serving/batches"]
        assert res["fallback_batches"] == runs[0]["fallback_batches"]


def test_a_failed_flush_raises_on_every_rank(world):
    """Rank 1's second flush raises: every rank's threads and ``stop()``
    end with ``ServingMeshError`` (the clients', the trainer's), naming
    rank 1's failure, within the request timeout (the services' groups
    time out at half of it) and a margin; no thread is left running."""
    for r, rank in enumerate(world["ranks"]):
        f = rank["failure"]
        assert not any(f["alive"])
        kinds = {(what, kind) for what, kind, _ in f["raised"]}
        assert {k for _, k in kinds} == {"ServingMeshError"}, f["raised"]
        assert ("stop", "ServingMeshError") in kinds
        assert ("step", "ServingMeshError") in kinds
        assert all("rank 1" in msg and "injected read failure" in msg
                   for _, _, msg in f["raised"]), f["raised"]
        assert f["s"] < 3 * FAIL_TIMEOUT_S, f["s"]
