"""Single-box multi-process PS cluster (port of ``repro/launch/
cluster.py``): spawn one trainer + k embedding-PS processes, train over
the RPC wire, and (optionally) kill a shard mid-run to exercise the
elastic recovery path end to end.

Usage (on the card; ``--device cpu`` runs the trainer and the PS
processes on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.cluster --steps 20 --ps 2
    PYTHONPATH=src python -m repro_torch.launch.cluster --steps 20 --ps 3 \
        --kill-shard 1 --kill-at 8       # SIGKILL shard 1 before step 8

Each PS process (``python -m repro_torch.net.ps_server``, never a fork of
a process that has started CUDA) binds port 0 and publishes its actual
port through a ``--port-file`` (written atomically by the server once
listening), so parallel launches never race on ports. Every shard spools
applied state next to its port file; when a shard is killed, the trainer
reshards its rows from that spool onto the survivors and keeps stepping —
the membership events and any lost rows land in the end-of-run summary.
The PS processes run on the trainer's device and load the kernels from
the same build directory (``kernels/build.py`` locks it, so one process
compiles and the others wait).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapters
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.data.ctr import CTRDataset
from repro_torch.device import resolve_device
from repro_torch.launch.shards import apply_backend_choice
from repro_torch.net.elastic import ElasticPSCluster, PSMember
from repro_torch.optim.optimizers import OptConfig

# the src/ directory the PS processes import the port from
_SRC = str(Path(__file__).resolve().parents[2])


def wait_for_port_file(port_file: str, proc: subprocess.Popen,
                       timeout: float = 30.0) -> int:
    """Poll for the server's atomically-written port file; fails fast if
    the process died before publishing."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"ps_server exited with {proc.returncode} before "
                f"publishing {port_file}")
        try:
            with open(port_file) as f:
                text = f.read().strip()
            if text:
                return int(text)
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    raise TimeoutError(f"no port published at {port_file} "
                       f"within {timeout:.0f}s")


def _start_ps(workdir: str, idx: int, host: str, spool_every: int,
              reply_delay: float, device: str):
    """Start PS process ``idx`` -> (its member record with port 0, its
    port file). Its output goes to ``ps<idx>.log`` in ``workdir``."""
    port_file = os.path.join(workdir, f"ps{idx}.port")
    spool_dir = os.path.join(workdir, f"ps{idx}.spool")
    if os.path.exists(port_file):
        os.remove(port_file)          # an earlier run's port is not ours
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.net.ps_server",
           "--host", host, "--port", "0", "--port-file", port_file,
           "--spool-dir", spool_dir, "--spool-every", str(spool_every),
           "--device", str(device)]
    if reply_delay > 0:
        cmd += ["--reply-delay", str(reply_delay)]
    with open(os.path.join(workdir, f"ps{idx}.log"), "w") as log:
        proc = subprocess.Popen(cmd, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
    return PSMember(host, 0, spool_dir=spool_dir, proc=proc), port_file


def spawn_cluster(workdir: str, n_ps: int, host: str = "127.0.0.1",
                  spool_every: int = 1, timeout: float = 60.0,
                  reply_delay: float = 0.0,
                  device: str = "cuda") -> list[PSMember]:
    """Start ``n_ps`` PS shard processes on ``device`` together, then wait
    for each to publish its port; returns their member records (endpoint
    + spool dir + process handle). Process ``i`` publishes its port in
    ``ps<i>.port``, spools into ``ps<i>.spool`` and prints to ``ps<i>.log``
    in ``workdir``. ``reply_delay`` injects a per-op reply
    latency server-side (a synthetic network RTT the pipelined transport
    should overlap, the blocking one pays per op). On any failure every
    process started is killed."""
    os.makedirs(workdir, exist_ok=True)
    started = []
    try:
        for i in range(n_ps):
            started.append(_start_ps(workdir, i, host, spool_every,
                                      reply_delay, device))
        for m, port_file in started:
            m.port = wait_for_port_file(port_file, m.proc, timeout)
    except BaseException:
        stop_ps([m for m, _ in started])
        raise
    return [m for m, _ in started]


def mesh_cluster(workdir: str, n_ps: int, **kw) -> tuple[list, list]:
    """PS start-up for a mesh world (collective: every rank of the mesh in
    scope calls it): the mesh's first rank, which holds a remote table's
    connections under a mesh, starts ``n_ps`` PS processes
    (:func:`spawn_cluster` with ``kw``) and sends every rank their
    endpoints. Returns ``(members, endpoints)``: the members on the first
    rank (stop them with :func:`stop_ps`), none on the others. Connect
    the tables with ``connect_remote_backends`` under the same mesh. A
    failed start raises on every rank."""
    from repro_torch.utils import from_rank0, get_mesh
    mesh = get_mesh()
    members, error = [], None
    if mesh is None or mesh.rank == 0:
        try:
            members = spawn_cluster(workdir, n_ps, **kw)
        except Exception as e:          # noqa: BLE001
            if mesh is None or mesh.n_ranks == 1:
                raise
            error = e
    eps, failed = from_rank0(([(m.host, m.port) for m in members],
                              None if error is None
                              else f"{type(error).__name__}: {error}"))
    if error is not None:
        raise error
    if failed is not None:
        raise RuntimeError(f"the mesh's first rank could not start the PS "
                           f"processes: {failed}")
    return members, eps


def stop_ps(members):
    """Kill every member process still running and reap it."""
    for m in members:
        if m.proc is not None and m.proc.poll() is None:
            m.proc.kill()
        if m.proc is not None:
            m.proc.wait(timeout=30)


def small_ctr_trainer(mode: str = "hybrid", backend: str = "host_lru",
                      tau: int = 2, fields: int = 2,
                      rows_per_field: int = 64, dim: int = 8,
                      cache_rows: int = 48, seed: int = 0,
                      device: str = "cuda"):
    """A small CTR trainer + batch stream (the tests' model, sized so a
    run finishes in seconds on the CPU), on ``device``."""
    cfg = ModelConfig(name="cluster", arch_type="recsys",
                      n_id_fields=fields, ids_per_field=3,
                      emb_dim=dim, emb_rows=fields * rows_per_field,
                      n_dense_features=4, mlp_dims=(16,), n_tasks=1)
    ds = CTRDataset("cluster", n_rows=fields * rows_per_field,
                    n_fields=fields, ids_per_field=3, n_dense=4)
    coll = adapters.ctr_collection(cfg, lr=5e-2, field_rows=ds.field_rows())
    coll = apply_backend_choice(coll, backend, cache_rows)
    ad = adapters.recsys_adapter(cfg, field_rows=ds.field_rows(),
                                 collection=coll)
    tm = {"sync": TrainMode.sync(), "hybrid": TrainMode.hybrid(tau),
          "async": TrainMode.async_(tau, tau)}[mode]
    trainer = PersiaTrainer(ad, tm, OptConfig(kind="adam", lr=5e-3),
                            device=device)
    return trainer, ds


def run_cluster(steps: int = 20, n_ps: int = 2, mode: str = "hybrid",
                backend: str = "host_lru", batch: int = 16,
                kill_shard: int | None = None, kill_at: int | None = None,
                lossy: bool | None = None, spool_every: int = 1,
                workdir: str | None = None, seed: int = 0,
                heartbeats: bool = True, pipelined: bool = True,
                put_window: int | None = None,
                reply_delay: float = 0.0, device: str = "cuda",
                trainer=None, ds=None) -> dict:
    """Spawn the cluster, train ``steps`` steps, optionally SIGKILL one
    shard mid-run, and return a summary (steps/s, each step's seconds,
    loss, membership events, lost rows, recovery seconds: the step the
    kill fell in). ``pipelined=False`` selects the
    blocking per-op-round-trip wire baseline; ``put_window`` overrides the
    outstanding-ack window (default: 1 for sync, min(tau, 8) for hybrid);
    ``reply_delay`` injects per-op reply latency PS-side. The trainer and
    the PS processes run on ``device`` (the card by default; raises
    without a GPU unless ``"cpu"``). ``trainer``/``ds`` replace the small
    CTR model (and its dataset) with a built trainer on ``device``."""
    device = str(resolve_device(device))
    workdir = workdir or tempfile.mkdtemp(prefix="ps_cluster_")
    if trainer is None:
        trainer, ds = small_ctr_trainer(mode=mode, backend=backend,
                                        seed=seed, device=device)
    members, cluster = [], None
    try:
        members = spawn_cluster(workdir, n_ps, device=device,
                                spool_every=spool_every,
                                reply_delay=reply_delay)
        cluster = ElasticPSCluster(trainer, members)
        cluster.connect(lossy=lossy, pipelined=pipelined,
                        put_window=put_window)
        if heartbeats:
            cluster.start_heartbeats(interval=0.3, miss_threshold=2)
        it = ds.sampler(batch, seed=seed)
        first = next(it)
        state = trainer.init(seed, first)
        metrics, recovery_s, step_s = {}, None, []
        t0 = time.monotonic()
        for t in range(steps):
            killed = False
            if kill_shard is not None and t == (kill_at or steps // 2):
                proc = cluster.members[kill_shard].proc
                if proc is not None:
                    proc.kill()
                    proc.wait()
                    killed = True
            t_step = time.monotonic()
            state, metrics = cluster.step(state, first if t == 0
                                          else next(it))
            step_s.append(time.monotonic() - t_step)
            if killed:
                recovery_s = step_s[-1]
        for name, bk in trainer.backends.items():
            bk.sync(state.emb[name])
        dt = time.monotonic() - t0
        return {
            "steps": steps,
            "steps_per_s": steps / max(dt, 1e-9),
            "loss": float(metrics.get("loss", float("nan"))),
            "members": len(cluster.members),
            "events": list(cluster.events)
            + ([] if cluster.monitor is None
               else list(cluster.monitor.events)),
            "lost_rows": {k: v for e in cluster.events
                          if e["kind"] == "reshard"
                          for k, v in e["lost_rows"].items()},
            "recovery_s": recovery_s,
            "step_s": step_s,
            "device": device,
            "workdir": workdir,
        }
    finally:
        if cluster is not None:
            cluster.close()
        stop_ps(members)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="one-box multi-process embedding-PS training run")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ps", type=int, default=2,
                    help="number of PS shard processes")
    ap.add_argument("--mode", default="hybrid",
                    choices=["sync", "hybrid", "async"])
    ap.add_argument("--backend", default="host_lru",
                    choices=["dense", "host_lru"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--kill-shard", type=int, default=None,
                    help="SIGKILL this shard index mid-run (fault drill)")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="step before which the kill fires (default mid)")
    ap.add_argument("--lossy", action="store_true", default=None,
                    help="blockscale-fp16 wire payloads")
    ap.add_argument("--spool-every", type=int, default=1)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--transport", default="pipelined",
                    choices=["pipelined", "blocking"],
                    help="wire path: coalesced async (default) or the "
                         "per-op synchronous-round-trip baseline")
    ap.add_argument("--put-window", type=int, default=None,
                    help="outstanding-ack window per table-shard "
                         "(default: 1 sync, min(tau, 8) hybrid)")
    ap.add_argument("--reply-delay", type=float, default=0.0,
                    help="server-side per-op reply latency in seconds "
                         "(synthetic network RTT)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    res = run_cluster(steps=args.steps, n_ps=args.ps, mode=args.mode,
                      backend=args.backend, batch=args.batch,
                      kill_shard=args.kill_shard, kill_at=args.kill_at,
                      lossy=args.lossy, spool_every=args.spool_every,
                      workdir=args.workdir,
                      pipelined=args.transport == "pipelined",
                      put_window=args.put_window,
                      reply_delay=args.reply_delay, device=args.device)
    print(f"cluster: {res['steps']} steps @ {res['steps_per_s']:.2f} "
          f"steps/s on {res['device']}, final loss {res['loss']:.4f}, "
          f"{res['members']} PS members at exit")
    for e in res["events"]:
        print(f"  event: {e}")
    if res["lost_rows"]:
        print(f"  lost rows on reshard: {res['lost_rows']}")
    return res


if __name__ == "__main__":
    main()
