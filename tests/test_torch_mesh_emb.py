"""The port's embedding tiers under a ``torch.distributed`` mesh that the
earlier mesh worlds do not run: the sharded router over dense and
host_lru shards (also behind the compressed wire), occurrence-width
host_lru tables, host_lru's serve read, the pipelined trainer with
host_lru tables, the router's checkpoints, and remote tables over PS
processes (also behind the lossy wire).

One world of 4 gloo processes (a (data 2, model 2) mesh, ``file://``
rendezvous in tmp_path) runs every part once (``WORLD``); each test
reads its part. The same script run as a world of one (no process group,
no mesh) is the port's one-process remote run, against PS processes of
its own, beside the world. The other oracle is the JAX package with no
mesh on the global batch, from the JAX checkpoint the world starts from,
computed in this process while the world runs.

Tolerance classes:
* against JAX with no mesh (the router, occurrence width, the pipeline's
  serial run): losses rtol 1e-5; tables rtol 1e-5 / atol 1e-6;
  accumulators atol 1e-9 (rtol 1e-5); LRU counters, slot maps and slot
  ids equal on every rank (the mesh's puts add the ranks' sums in
  another order than one device: the class of
  ``tests/test_torch_distributed.py``);
* bit for bit: a checkpoint saved under the mesh and restored by JAX and
  by one port process; the serve read's pooled rows against one port
  process reading the same state; PS op counts (puts, faults, hits, the
  PS process's apply-only launches) against one process's;
* the serve read against JAX's ``read_rows``, pooled: atol 1e-6;
* the pipelined trainer at ``max_inflight=1`` against the serial trainer
  under the mesh: rtol 1e-5 / atol 1e-6 (the JAX pipeline test's bound);
  the deep run: its puts in batch order, the slot maps and counters
  equal on every rank;
* remote tables against the port's one-process remote run: losses rtol
  1e-5, the PS's rows rtol 1e-5 / atol 1e-6, accumulators atol 1e-9
  (the mesh's global put adds the ranks' sums in another order);
* behind the wire (the router's compressed wire, a remote table's lossy
  one; the block is the dim): tables, host stores and served rows in the
  lossy class of ``tests/test_torch_train.py`` (``_close_lossy``: at most
  1% of the elements outside rtol 1e-5 / atol 1e-6, each within 1e-4,
  served pooled rows within 1e-3): a payload value on an fp16 rounding
  boundary rounds one way or the other.
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

from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapters
from repro_torch.core import backend as BK
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.data.ctr import CTRDataset
from repro_torch.launch.cluster import spawn_cluster, stop_ps
from repro_torch.optim.optimizers import OptConfig
from test_torch_train import _close_lossy

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
N_RANKS = 4
CTR_KW = dict(name="me", arch_type="recsys", n_id_fields=3, ids_per_field=2,
              emb_dim=8, emb_rows=192, n_dense_features=4, mlp_dims=(16,),
              n_tasks=1)
DS_KW = dict(name="me", n_rows=192, n_fields=3, ids_per_field=2, n_dense=4)
BATCH, EMB_LR, DENSE_LR, TAU = 32, 5e-2, 5e-3, 2
# JAX steps before its checkpoint, mesh steps after it, the router's save
PRE, STEPS, SAVE = 2, 4, 2
# each cell: {table: (backend, cache_rows, spec fields)} over the three
# 64-row field tables. A batch reads about 22 of a table's 64 rows. The
# router's 2 dense shards hold 32 rows each (no two ids share a row); its
# host_lru shards 16 slots each, 4 a rank (row-sharded), and evict. The
# serve cell's tables: 32 slots (row-sharded), 34 (replicated: 34 does
# not divide the 4 ranks), +disk with a 32-row host tier. The pipeline's
# 40 slots (row-sharded) hold two batches in flight and evict.
_T = ("field_00", "field_01", "field_02")
CELLS = {
    "router_dense": dict.fromkeys(_T, ("dense", 0, {"emb_shards": 2})),
    "router_lru": dict.fromkeys(_T, ("host_lru", 32, {"emb_shards": 2})),
    "flat_lru": dict.fromkeys(_T, ("host_lru", 32, {"batch_dedup": False})),
    "serve_lru": {"field_00": ("host_lru", 32, {}),
                  "field_01": ("host_lru", 34, {}),
                  "field_02": ("host_lru+disk", 32, {"host_rows": 32})},
    "pipe_lru": dict.fromkeys(_T, ("host_lru", 40, {})),
    "router_wire": dict.fromkeys(_T, ("host_lru+compressed", 32, {
        "emb_shards": 2, "wire_block": 8})),
}
SERVE_TABLES = {"lru_sharded": "field_00", "lru_replicated": "field_01",
                "lru_disk": "field_02"}
# remote tables: one PS process with the dense tables, two with host_lru
# tables (the remote router over them), one with the dense tables behind
# the lossy wire (its block the dim); the router over host_lru shards
# behind the compressed wire runs in the world beside the other cells
REMOTE = {"remote_dense": ("dense", 0, 1), "remote_lru": ("host_lru", 32, 2),
          "remote_lossy": ("dense+compressed", 0, 1)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _batches():
    it = CTRDataset(**DS_KW).sampler(BATCH, seed=5)
    return [next(it) for _ in range(PRE + STEPS + 1)]   # the last: serve


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


def _lru_subs(backends, unwrap) -> dict:
    """{table or table/s<k>: host_lru backend} of a trainer's tables."""
    out = {}
    for n, b in backends.items():
        b = unwrap(b)
        for k, sub in enumerate(getattr(b, "shard_backends", None) or [b]):
            if hasattr(sub, "_id_for_slot"):
                out[n if sub is b else f"{n}/s{k}"] = sub
    return out


def _counters(backends, unwrap) -> dict:
    return {n: {"counts": (b.faults, b.writebacks, b.hits, b.admits),
                "id_for_slot": np.asarray(b._id_for_slot).copy(),
                "store": b.store.serialize()}
            for n, b in _lru_subs(backends, unwrap).items()}


WORLD = textwrap.dedent("""
    import dataclasses, datetime, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, n, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    from repro_torch.core import adapters
    from repro_torch.core import backend as BK
    from repro_torch.core.hybrid import PersiaTrainer
    from repro_torch.core.pipeline import PipelinedTrainer
    from repro_torch.launch.cluster import mesh_cluster, stop_ps
    from repro_torch.net import connect_remote_backends
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.sharding import partition as SP
    from repro_torch.utils import Mesh, set_mesh

    with open(f"{work}/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    C = inp["cfg"]

    def trainer(cell, disk=None):
        def one(name, sp):
            b, cache, kw = C["cells"][cell][name]
            kw = dict(kw)
            if b.endswith("+disk"):
                kw["disk_path"] = f"{disk}/{name}"
            return dataclasses.replace(sp, backend=b, cache_rows=cache, **kw)
        coll = adapters.ctr_collection(
            C["ctr"], lr=C["lr"][0], field_rows=C["rows"]).map_specs(one)
        return PersiaTrainer(
            adapters.recsys_adapter(C["ctr"], field_rows=C["rows"],
                                    collection=coll),
            C["mode"], OptConfig(kind="adam", lr=C["lr"][1]), device="cpu")

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
        return host({"emb": g.emb, "queue": g.emb_queue, "dense": g.dense})

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

    def remote_run(cell, endpoints, batches, serve_batch):
        base, cache, _ = C["remote"][cell]
        coll = adapters.ctr_collection(
            C["ctr"], lr=C["lr"][0], field_rows=C["rows"]).with_backend(
            base, cache).map_specs(
            lambda _, sp: dataclasses.replace(sp, wire_block=sp.dim))
        tr = PersiaTrainer(
            adapters.recsys_adapter(C["ctr"], field_rows=C["rows"],
                                    collection=coll),
            C["mode"], OptConfig(kind="adam", lr=C["lr"][1]), device="cpu")
        connect_remote_backends(tr, endpoints)
        s = tr.init(seed=3, batch_example=batches[0])
        losses = []
        for b in batches:
            s, m = tr.step(s, b)
            losses.append(float(m["loss"]))
        subs = {(name, k): sub for name, b in tr.backends.items()
                for k, sub in enumerate(getattr(b, "shard_backends", None)
                                        or [b])}
        clients = {id(sub._client): sub._client for sub in subs.values()
                   if sub._client is not None}
        # the frames the training steps sent (a serve read below sends
        # one read per rank's block)
        rec = {"frames": sum(c.frames_sent for c in clients.values()),
               "connected": bool(clients)}
        pooled, info = tr.serve_lookup(s, serve_batch)
        rec.update(losses=losses, serve=host(pooled), serve_info=info)
        if rank == 0:
            rec["blobs"] = {name: b.state_for_checkpoint(s.emb[name])
                            for name, b in tr.backends.items()}
            rec["metrics"] = {f"{name}/s{k}": {
                key: v for key, v in sub.remote_metrics().items()
                if key in ("puts", "faults", "hits")}
                for (name, k), sub in subs.items()}
            rec["ps_launches"] = [
                sub._client.call("metrics")["launches"]
                for (name, k), sub in subs.items() if name == "field_00"]
        for b in tr.backends.values():
            b.close()
        return rec

    out = {}
    if n == 1:
        # the one-process remote run, on the global batches
        for cell in C["remote"]:
            out[cell] = remote_run(cell, inp["ps_one"][cell],
                                   inp["batches"][:C["steps"]],
                                   inp["batches"][-1])
        with open(f"{work}/one.pkl", "wb") as f:
            pickle.dump(host(out), f)
        print("ONE_OK")
        sys.exit(0)

    dist.init_process_group("gloo", init_method=f"file://{work}/rdzv",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=90))
    mesh = Mesh((2, 2), ("data", "model"), "cpu")
    with set_mesh(mesh):
        bat = lambda b: {k: SP.local_block(mesh, SP.P(SP.BATCH), torch.as_tensor(
            np.asarray(v))).numpy() for k, v in b.items()}
        batches = [bat(b) for b in inp["batches"]]
        P0, T, SAVE = C["steps_at"]
        run = batches[P0:P0 + T]
        for cell in ("router_dense", "router_lru", "flat_lru", "serve_lru",
                     "router_wire"):
            disk = f"{work}/disk_{cell}"
            tr = trainer(cell, disk)
            s = tr.restore(inp["jax_ckpt"][cell])
            rec = {"losses": []}
            for i, b in enumerate(run):
                s, m = tr.step(s, b)
                rec["losses"].append(float(m["loss"]))
                if cell.startswith("router") and i + 1 == SAVE:
                    tr.save(f"{work}/mesh_{cell}", s)
                    rec["ckpt"] = f"{work}/mesh_{cell}"
                    rec["saved"] = glob(tr, s)
            rec.update(glob(tr, s), counters=counters(tr))
            if cell == "serve_lru":
                before = counters(tr)
                pooled, info = tr.serve_lookup(s, batches[-1])
                rows = tr.lookup(s, batches[-1])
                rec["serve"] = {"pooled": host(pooled), "info": info,
                                "rows": host(rows),
                                "unchanged": all(
                                    np.array_equal(before[k]["id_for_slot"],
                                                   c["id_for_slot"])
                                    and before[k]["counts"] == c["counts"]
                                    for k, c in counters(tr).items())}
                tr.save(f"{work}/mesh_serve", s)
                rec["ckpt"] = f"{work}/mesh_serve"
            out[cell] = rec
        # the pipelined trainer with host_lru: max_inflight=1 and serial
        # from one state, then a deep run
        pipe = {}
        for runner in ("serial", "inflight_1", "deep"):
            tr = trainer("pipe_lru")
            s = tr.restore(inp["jax_ckpt"]["pipe_lru"])
            if runner == "serial":
                s, ms = tr.run(s, run)
            else:
                eng = PipelinedTrainer(tr, max_inflight=1 if
                                       runner == "inflight_1" else 2)
                s, ms = eng.run(s, run)
                pipe[runner + "_order"] = list(eng.applied_order)
            pipe[runner] = dict(glob(tr, s), counters=counters(tr),
                                losses=[float(m["loss"]) for m in ms])
        out["pipe_lru"] = pipe
        # remote tables: the mesh's first rank holds the connections; the
        # dense table's PS process started by it (launch/cluster.py)
        members, eps = mesh_cluster(f"{work}/ps_world", 1, spool_every=0,
                                    device="cpu")
        try:
            for cell in C["remote"]:
                out[cell] = remote_run(
                    cell, eps if cell == "remote_dense"
                    else inp["ps_mesh"][cell], batches[:C["steps"]],
                    batches[-1])
        finally:
            stop_ps(members)
    dist.barrier()
    with open(f"{work}/rank{rank}.pkl", "wb") as f:
        pickle.dump(host(out), f)
    dist.destroy_process_group()
    print("RANK_OK", rank)
""")


def _jax_inputs(work) -> tuple[dict, object]:
    """Each JAX cell's checkpoint after PRE steps (the world restores it),
    and a function that computes the oracles (JAX's next STEPS steps)."""
    batches, ckpts, runs = _batches(), {}, {}
    for cell in CELLS:
        jt = _jax_trainer(cell)
        js = jt.init(jax.random.PRNGKey(1), _jnp(batches[0]))
        for b in batches[:PRE]:
            js, _ = jt.step(js, _jnp(b))
        ckpts[cell] = str(work / f"jax_{cell}")
        jt.save(ckpts[cell], js)
        runs[cell] = (jt, js)

    def oracle():
        out = {}
        for cell, (jt, js) in runs.items():
            losses = []
            for b in batches[PRE:PRE + STEPS]:
                js, m = jt.step(js, _jnp(b))
                losses.append(float(m["loss"]))
            out[cell] = {"losses": losses, "emb": _np(js.emb),
                         "dense": _np(js.dense),
                         "counters": _counters(jt.backends, jbackend.unwrap),
                         "trainer": jt, "state": js}
        return out
    return ckpts, oracle


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Runs the world and the one-process remote run once for the module:
    ``{"ranks": [rank result], "one": one-process remote run, "oracle":
    JAX's runs}``."""
    work = tmp_path_factory.mktemp("mesh_emb")
    members = []
    try:
        # the one process's PS processes and the mesh's (but the one the
        # world's first rank starts for its dense tables)
        want = [("ps_one", c, k) for c, (_, _, k) in REMOTE.items()] + \
            [("ps_mesh", c, k) for c, (_, _, k) in REMOTE.items()
             if c != "remote_dense"]
        members = spawn_cluster(str(work / "ps"), sum(k for *_, k in want),
                                spool_every=0, device="cpu")
        eps = [("127.0.0.1", m.port) for m in members]
        ps = {"ps_mesh": {}, "ps_one": {}}
        for key, cell, k in want:
            ps[key][cell], eps = eps[:k], eps[k:]
        ckpts, oracle = _jax_inputs(work)
        inp = {"cfg": {"ctr": ModelConfig(**CTR_KW),
                       "rows": CTRDataset(**DS_KW).field_rows(),
                       "lr": (EMB_LR, DENSE_LR), "mode": TrainMode.hybrid(TAU),
                       "cells": CELLS, "remote": REMOTE,
                       "steps_at": (PRE, STEPS, SAVE), "steps": STEPS},
               "batches": _batches(), "jax_ckpt": ckpts, **ps}
        with open(work / "inputs.pkl", "wb") as f:
            pickle.dump(inp, f)
        (work / "world.py").write_text(WORLD)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([str(SRC),
                                             env.get("PYTHONPATH", "")])
        procs = [subprocess.Popen(
            [sys.executable, str(work / "world.py"), str(r), str(n),
             str(work)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r, n in [(r, N_RANKS) for r in range(N_RANKS)] + [(0, 1)]]
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
    for r, log in enumerate(logs[:-1]):
        assert f"RANK_OK {r}" in log, f"rank {r}:\n{log[-4000:]}"
    assert "ONE_OK" in logs[-1], logs[-1][-4000:]
    ranks = []
    for r in range(N_RANKS):
        with open(work / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with open(work / "one.pkl", "rb") as f:
        one = pickle.load(f)
    return {"ranks": ranks, "one": one, "oracle": ora, "inputs": inp}


def _close(got, want, atol, what, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _equal_trees(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        for k in want:
            _equal_trees(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _equal_trees(g, w, f"{what}/{i}")
    elif want is None:
        assert got is None, what
    elif np.ndim(want) == 0:
        assert int(np.asarray(got)) == int(np.asarray(want)), what
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, what
        np.testing.assert_array_equal(g, w, err_msg=what)


def _leaves(tree, path=""):
    """{path: array} of a state's tables (a router's shard by shard)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    return {path: np.asarray(tree)}


def _hold_against_jax(got, ora, ranks, cell, lossy=False):
    """Losses rtol 1e-5; tables rtol 1e-5 / atol 1e-6 (behind the wire
    ``lossy``: ``_close_lossy``, each element within 1e-4), accumulators
    atol 1e-9, slot ids equal; every rank's LRU counters and slot maps
    equal JAX's, host stores allclose (behind the wire in the lossy
    class); dense parameters rtol 1e-5 / atol 1e-6."""
    _close(got["losses"], ora["losses"], 0, "losses", rtol=1e-5)
    want = _leaves(ora["emb"])
    mine = _leaves(got["emb"])
    assert set(mine) == set(want), (sorted(mine), sorted(want))
    for k, w in want.items():
        if k.endswith("slot_ids"):
            np.testing.assert_array_equal(mine[k], w, err_msg=k)
        elif k.endswith("acc"):
            _close(mine[k], w, 1e-9, k, 1e-5)
        elif lossy:
            _close_lossy(mine[k], w, 1e-4, k)
        else:
            _close(mine[k], w, 1e-6, k, 1e-5)
    for r in ranks:
        rc = r[cell]["counters"]
        assert set(rc) == set(ora["counters"])
        for n, c in ora["counters"].items():
            assert rc[n]["counts"] == c["counts"], (n, rc[n]["counts"])
            np.testing.assert_array_equal(rc[n]["id_for_slot"],
                                          c["id_for_slot"])
            if "disk" not in c["store"]:
                for k in ("vectors", "opt_acc"):
                    if lossy and k == "vectors":
                        _close_lossy(rc[n]["store"][k], c["store"][k], 1e-4,
                                     k)
                    else:
                        _close(rc[n]["store"][k], c["store"][k], 1e-6, k,
                               1e-5)
    for a, b in zip(jax.tree.leaves(got["dense"]),
                    jax.tree.leaves(ora["dense"])):
        _close(a, b, 1e-6, "dense", 1e-5)


@pytest.mark.parametrize("cell", ["router_dense", "router_lru", "flat_lru",
                                  "router_wire"])
def test_tier_under_mesh_matches_jax(world, cell):
    """4 hybrid(2) steps under the (2, 2) mesh from JAX's checkpoint
    against JAX's trainer with no mesh on the global batch: the router
    over 2 dense shards and over 2 host_lru shards that evict (also
    behind the compressed wire: its tables in the lossy class of
    ``tests/test_torch_train.py``), and a host_lru table at occurrence
    width (``batch_dedup=False``), in the class of
    ``_hold_against_jax``."""
    ora = world["oracle"][cell]
    _hold_against_jax(world["ranks"][0][cell], ora, world["ranks"], cell,
                      lossy=cell == "router_wire")
    if cell != "router_dense":
        assert all(c["counts"][1] > 0 for c in ora["counters"].values())


@pytest.mark.parametrize("cell", ["router_dense", "router_lru"])
def test_router_checkpoint_restores_in_jax_and_one_process(world, cell):
    """The router's checkpoint saved under the mesh (after 2 of the 4
    steps; the JAX package's shard-tagged format), restored by JAX and by
    one port process: tables, caches, host tiers, queues and dense
    parameters equal the joined mesh state bit for bit."""
    got = world["ranks"][0][cell]
    saved = got["saved"]
    jt, tt = _jax_trainer(cell), _port_trainer(cell)
    js, ts = jt.restore(got["ckpt"]), tt.restore(got["ckpt"])
    _equal_trees(_leaves(_np(js.emb)), _leaves(saved["emb"]), "jax emb")
    _equal_trees(_leaves(convert.state_to_numpy(ts)["emb"]),
                 _leaves(saved["emb"]), "port emb")
    _equal_trees(_np(js.emb_queue), saved["queue"], "jax queue")
    _equal_trees(convert.state_to_numpy(ts)["emb_queue"], saved["queue"],
                 "port queue")
    _equal_trees(convert.state_to_numpy(ts)["dense"], saved["dense"],
                 "port dense")
    jc = _counters(jt.backends, jbackend.unwrap)
    tc = _counters(tt.backends, BK.unwrap)
    assert set(jc) == set(tc)
    for n in jc:
        assert jc[n]["counts"][:3] == tc[n]["counts"][:3]
        _equal_trees(tc[n]["store"], jc[n]["store"], n)


def _serve_one_process(world):
    """One port process restores the serve cell's state (saved under the
    mesh) and reads every rank's block of the serve batch."""
    tt = _port_trainer("serve_lru")
    ts = tt.restore(world["ranks"][0]["serve_lru"]["ckpt"])
    batch = world["inputs"]["batches"][-1]
    half = BATCH // 2
    blocks = [{k: v[d * half:(d + 1) * half] for k, v in batch.items()}
              for d in range(2)]
    return tt, ts, blocks


@pytest.mark.parametrize("kind", list(SERVE_TABLES))
def test_serve_read_under_mesh(world, kind):
    """host_lru's serve read under the mesh, each rank reading its own
    block of requests (a row-sharded cache, a replicated one, ``+disk``),
    after 4 steps that evict: the pooled rows and the occurrence rows
    equal one port process's read of the same state bit for bit; the
    pooled rows are JAX's ``read_rows`` of that state, pooled, within
    atol 1e-6; the read moves no counter or slot; it has hits and
    misses."""
    name = SERVE_TABLES[kind]
    tt, ts, blocks = _serve_one_process(world)
    jt = _jax_trainer("serve_lru")
    js = jt.restore(world["ranks"][0]["serve_lru"]["ckpt"])
    for r, rank in enumerate(world["ranks"]):
        got = rank["serve_lru"]["serve"]
        assert got["unchanged"]
        block = blocks[r // 2]               # the data rank's rows
        pooled, info = tt.serve_lookup(ts, block)
        np.testing.assert_array_equal(got["pooled"][name],
                                      pooled[name].numpy())
        assert got["info"][name] == info[name]
        rows = tt.lookup(ts, block)
        np.testing.assert_array_equal(got["rows"][name], rows[name].numpy())
        ids = np.asarray(tt.adapter.emb_ids(block)[name])
        jrows, _ = jbackend.unwrap(jt.backends[name]).read_rows(
            js.emb[name], jnp.asarray(ids))
        jpooled = np.where((ids >= 0)[..., None], np.asarray(jrows),
                           0.0).sum(1)
        _close(got["pooled"][name], jpooled, 1e-6, f"{kind} vs jax")
    info = world["ranks"][0]["serve_lru"]["serve"]["info"][name]
    assert info["hits"] > 0 and info["misses"] > 0, info


@pytest.mark.parametrize("runner", ["inflight_1", "deep"])
def test_pipelined_lru_under_mesh(world, runner):
    """The pipelined trainer with host_lru tables under the mesh:
    ``max_inflight=1`` against the serial trainer under the mesh (rtol
    1e-5 / atol 1e-6, every rank's counters and slot maps equal); the
    deep run (``max_inflight=2``) applies its puts in batch order and
    every rank holds one process's slot maps, counters and stores."""
    pipes = [r["pipe_lru"] for r in world["ranks"]]
    got, serial = pipes[0][runner], pipes[0]["serial"]
    if runner == "inflight_1":
        _close(got["losses"], serial["losses"], 0, "losses", rtol=1e-5)
        for k, w in _leaves(serial["emb"]).items():
            _close(_leaves(got["emb"])[k], w, 1e-6, k, 1e-5)
        for a, b in zip(jax.tree.leaves(got["dense"]),
                        jax.tree.leaves(serial["dense"])):
            _close(a, b, 1e-6, "dense", 1e-5)
        for p in pipes:
            for n, c in p["serial"]["counters"].items():
                assert p[runner]["counters"][n]["counts"] == c["counts"]
                np.testing.assert_array_equal(
                    p[runner]["counters"][n]["id_for_slot"],
                    c["id_for_slot"])
    else:
        assert pipes[0]["deep_order"] == list(range(STEPS))
        assert np.isfinite(got["losses"]).all()
        assert all(c["counts"][1] > 0 for c in got["counters"].values())
    for p in pipes[1:]:
        assert p[runner + "_order"] == pipes[0][runner + "_order"]
        for n, c in pipes[0][runner]["counters"].items():
            assert p[runner]["counters"][n]["counts"] == c["counts"]
            np.testing.assert_array_equal(p[runner]["counters"][n]
                                          ["id_for_slot"], c["id_for_slot"])
            _equal_trees(p[runner]["counters"][n]["store"], c["store"], n)


@pytest.mark.parametrize("cell", list(REMOTE))
def test_remote_under_mesh_matches_one_process(world, cell):
    """Remote tables under the mesh (one PS process with the dense tables;
    the remote router over two PS processes with host_lru tables), the
    mesh's first rank holding the connections, against the port's
    one-process remote run from the same seed on the global batches:
    losses rtol 1e-5; the PS's rows rtol 1e-5 / atol 1e-6 and
    accumulators atol 1e-9 (the host_lru tiers' slot maps and counters
    equal); the PS's op counts (puts, faults, hits) and its processes'
    kernel launches equal one process's; the serve reads rtol 1e-5 /
    atol 1e-6 and equal on the ranks of one data row."""
    one, ranks = world["one"][cell], world["ranks"]
    got = ranks[0][cell]
    for r in ranks:
        assert r[cell]["losses"] == got["losses"]
    _close(got["losses"], one["losses"], 0, "losses", rtol=1e-5)
    mine, want = _leaves(got["blobs"]), _leaves(one["blobs"])
    assert set(mine) == set(want)
    lossy = cell == "remote_lossy"
    for k, w in want.items():
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(mine[k], w, err_msg=k)
        elif "acc" in k:
            _close(mine[k], w, 1e-9, k, 1e-5)
        elif lossy:
            _close_lossy(mine[k], w, 1e-4, k)
        else:
            _close(mine[k], w, 1e-6, k, 1e-5)
    assert got["metrics"] == one["metrics"]
    assert got["ps_launches"] == one["ps_launches"]
    assert got["frames"] == one["frames"] > 0
    assert [r[cell]["connected"] for r in ranks] == [True] + [False] * 3
    assert all(m["puts"] == len(got["losses"])
               for m in got["metrics"].values())
    half = BATCH // 2
    for r, rank in enumerate(ranks):
        d = r // 2
        for n, v in rank[cell]["serve"].items():
            block = one["serve"][n][d * half:(d + 1) * half]
            if lossy:
                _close_lossy(v, block, 1e-3, n)
            else:
                _close(v, block, 1e-6, n, 1e-5)
            np.testing.assert_array_equal(v, ranks[2 * d][cell]["serve"][n])


@pytest.mark.parametrize("op", ["state_for_checkpoint", "export_logical",
                                "remote_metrics"])
def test_remote_ops_off_the_first_rank_raise(op):
    """A remote table on a rank of the mesh that holds no PS connection
    raises a clear error for an op whose reply it would read, instead of
    handing its caller None."""
    from collections import deque
    from types import SimpleNamespace

    from repro_torch.net.remote import RemoteBackend
    b = object.__new__(RemoteBackend)
    b._lead, b._mesh, b._table = False, SimpleNamespace(rank=1), "t"
    b._acks, b._aux = deque(), deque()
    args = ({},) if op == "state_for_checkpoint" else ()
    with pytest.raises(RuntimeError, match="first rank alone"):
        getattr(b, op)(*args)
