#!/usr/bin/env python3
"""chip_smoke.py's mesh_emb part alone on one card, with the tiers whose
held state the serve read and the pipelined trainer run on:

    python3 tools/mesh_emb_part.py

A gloo world of 4 processes (mesh data 2 x model 2) runs
``mesh_tier_rank`` on the replicated and the row-sharded host_lru tiers
(with ``mesh_serve_read`` and ``mesh_pipeline``) and ``mesh_emb_rank``
(the router over 4 shards, also behind the wire, occurrence width, the
remote tables over PS processes this script starts); this process runs
the remote run's one-process reference beside it. Then ``mesh_emb_check`` with every failed
check recorded, not raised. Prints each part's seconds, per-step ms and
the check's record; writes ``chiprun_out/mesh_emb_part.json``. Needs a
GPU."""
import datetime
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

WORK = ROOT / "build" / "mesh_emb_part"
LRU_TIERS = tuple(t for t in cs.MESH_TIERS if t[0] in cs.MESH_EMB["serve"])


def worker(r):
    import torch.distributed as dist
    from repro_torch.utils import Mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build.build_all()
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{WORK}/rdzv",
                            rank=r, world_size=4,
                            timeout=datetime.timedelta(seconds=300))
    mesh = Mesh(cs.MESH_SHAPE, cs.MESH_AXES, "cuda")
    t0 = time.perf_counter()
    rec = {"tiers": cs.mesh_tier_rank(dev, mesh, str(WORK / "tiers"),
                                      LRU_TIERS)}
    rec["tiers_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["emb"] = cs.mesh_emb_rank(dev, mesh, str(WORK / "gloo"))
    rec["emb_s"] = time.perf_counter() - t0
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    dist.barrier()
    (WORK / f"rank{r}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t_all = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    (WORK / "gloo").mkdir(parents=True)
    (WORK / "tiers").mkdir(parents=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build.build_all()
    dev = torch.device("cuda", 0)
    members, eps = [], {}
    t0 = time.perf_counter()
    for key in ("mesh", "one"):
        ms = cs.ps_cluster.spawn_cluster(
            str(WORK / f"ps_{key}"), 1 + cs.REMOTE_K, spool_every=0,
            device="cuda")
        members += ms
        e = [(m.host, m.port) for m in ms]
        eps[key] = {"dense": e[:1], "lru": e[1:]}
    print("ps_start_s", time.perf_counter() - t0, flush=True)
    (WORK / "gloo" / "ps.json").write_text(json.dumps({"mesh": eps["mesh"]}))
    logs = [open(WORK / f"rank{r}.log", "w") for r in range(4)]
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(4)]
    try:
        t0 = time.perf_counter()
        ref = cs.mesh_remote_run(dev, None, eps["one"])
        print("ref_s", time.perf_counter() - t0, flush=True)
        for p in procs:
            p.wait(timeout=1200)
        print("world_s", time.perf_counter() - t0, flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        cs.ps_cluster.stop_ps(members)
    bad = [r for r in range(4) if procs[r].returncode != 0]
    for r in bad:
        print(f"RANK {r}:", (WORK / f"rank{r}.log").read_text()[-6000:])
    if bad:
        return 1
    gl = [json.loads((WORK / f"rank{r}.json").read_text()) for r in range(4)]
    fails = []
    cs.check = lambda cond, what: None if cond else fails.append(what)
    launches = dict.fromkeys(cs.ops.launch_counts(), 0)
    served = dict.fromkeys(cs.ops.table_counts(), 0)
    out = cs.mesh_emb_check(gl, gl, ref, WORK / "gloo", launches, served)
    out["fails"] = fails
    for f in fails:
        print("FAIL:", f[:3000], flush=True)
    for g in gl:
        parts = list(g["tiers"].items()) + list(g["emb"]["tiers"].items())
        print("tiers: warm steps, warm s, step ms", {
            t: (v["warm_steps"], round(v["warm_s"], 1),
                [round(x) for x in v["step_ms"]]) for t, v in parts})
        for t, v in g["tiers"].items():
            if "serve_read" in v:
                print("serve read", t, {k: v["serve_read"][k] for k in (
                    "bit_exact", "max_abs", "hits", "misses", "ms")})
        pipe = g["tiers"][cs.MESH_EMB["pipe"]]["pipeline"]
        print("pipeline s", {k: round(v["s"], 1) for k, v in pipe.items()
                             if isinstance(v, dict)})
        print("remote s", round(g["emb"]["remote"]["s"], 1))
    out["launches"] = launches
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "mesh_emb_part.json").write_text(
        json.dumps({"out": out, "ranks": gl}, default=str))
    for t, v in out["tiers"].items():
        print(t, json.dumps({k: v[k] for k in ("warm_steps", "losses",
                                              "losses_one_process",
                                              "per_step", "step_ms_per_rank",
                                              "launches_per_rank")}))
    print(json.dumps({k: v for k, v in out.items() if k != "tiers"},
                     default=str))
    print("EMB_OK" if not fails else "EMB_FAILED", "total_s",
          time.perf_counter() - t_all, flush=True)
    return 0 if not fails else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(int(sys.argv[2]))
    else:
        sys.exit(main())
