"""The embedding-PS process (port of ``repro/net/ps_server.py``): the
port's dense and host_lru backends hosted behind the RPC surface (paper
§4.1: the PS tier as its own service, with its own failure domain).

One server hosts any number of named tables; each table is a *plain* dense
or host_lru backend over the shard's local id space (the sharded geometry
lives client-side in ``RemoteShardedBackend``, as the in-process router
composes plain backends). The server owns the table state AND its
bounded-staleness queue: queued puts are PS-side state, so killing a shard
loses exactly the queue and the unacked requests, the paper's tolerated
in-flight loss, and nothing more, because applied puts are spooled to disk
*before* the ack (``--spool-every 1``).

The tables live on the server's ``device``: the card by default (the
server raises when no GPU is visible), the CPU when asked. A put arrives
as unique-width sums (the trainer ran the sum-only ``fused_backward``
launch) and is applied here by the backend's own apply, one apply-only
``fused_backward`` launch a table (with the popped put in hybrid mode); a
lookup or serve read gathers rows on the device and ships them as numpy.
The ``metrics`` op reports this process's kernel launch counts and the
seconds its ops took, so a trainer can see the apply-only launches a PS
process made.

``init`` draws the table from the trainer's ``torch.Generator`` state: the
server seeds a generator on its own device with it, draws exactly what the
in-process backend draws, and returns the advanced state, so the trainer's
generator goes on as if it had drawn the table itself. The generator must
be of the server's device type.

Run one process per shard::

    PYTHONPATH=src python -m repro_torch.net.ps_server --port 0 \\
        --port-file /tmp/ps0.port --spool-dir /tmp/ps0.spool

``--port 0`` binds an OS-assigned free port and publishes it through
``--port-file`` (written atomically), so launchers never race on ports.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import _read_blob, _write_blob
from repro_torch.core import backend as BK
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.net import wire
from repro_torch.net.rpc import RpcServer

MUTATING_OPS = frozenset({
    "configure", "init", "seed_rows", "queue_init", "put", "hybrid",
    "restore", "pin", "unpin", "reset_pins",
})


def read_spool(spool_dir: str, table: str):
    """Latest spooled state blob for ``table``, or None if never spooled."""
    root = os.path.join(spool_dir, table)
    cur = os.path.join(root, "CURRENT")
    if not os.path.exists(cur):
        return None
    with open(cur) as f:
        gen = f.read().strip()
    return _read_blob(os.path.join(root, gen))


class PSServer:
    """One PS shard process (or in-process thread, for tests)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 spool_dir: str | None = None, spool_every: int = 1,
                 reply_delay: float = 0.0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.spool_dir = spool_dir
        self.spool_every = int(spool_every)
        self._tables: dict[str, dict] = {}
        self._lock = threading.RLock()
        self._shutdown = threading.Event()
        handlers = {
            "ping": self._op_ping,
            "configure": self._op_configure,
            "init": self._op_init,
            "seed_rows": self._op_seed_rows,
            "queue_init": self._op_queue_init,
            "prepare": self._op_prepare,
            "lookup": self._op_lookup,
            "read_rows": self._op_read_rows,
            "put": self._op_put,
            "hybrid": self._op_hybrid,
            "pin": self._op_pin,
            "unpin": self._op_unpin,
            "reset_pins": self._op_reset_pins,
            "checkpoint": self._op_checkpoint,
            "restore": self._op_restore,
            "export_logical": self._op_export_logical,
            "metrics": self._op_metrics,
            "shutdown": self._op_shutdown,
            "die": self._op_die,
        }
        self.rpc = RpcServer({k: self._on_device(f)
                              for k, f in handlers.items()}, host, port,
                             mutating_ops=MUTATING_OPS,
                             reply_delay=reply_delay)

    @property
    def port(self) -> int:
        return self.rpc.port

    def start(self) -> "PSServer":
        self.rpc.start()
        return self

    def stop(self):
        self._shutdown.set()
        self.rpc.stop()

    def kill(self):
        """Simulate shard death for in-process (threaded) servers: drop all
        table state and stop answering — clients see connection errors,
        exactly as if the process was SIGKILLed. The spool survives."""
        self.stop()
        with self._lock:
            self._tables.clear()

    def wait(self):
        self._shutdown.wait()

    # -- helpers -------------------------------------------------------------

    def _on_device(self, fn):
        """A handler run with the server's device current: each connection
        is served on a thread of its own, which starts on device 0."""
        if self.device.type != "cuda":
            return fn

        def run(**kw):
            with torch.cuda.device(self.device):
                return fn(**kw)
        return run

    def _entry(self, table: str) -> dict:
        ent = self._tables.get(table)
        if ent is None:
            raise KeyError(f"table {table!r} not configured on this PS "
                           f"(have {sorted(self._tables)})")
        return ent

    @contextlib.contextmanager
    def _timed(self, ent: dict, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ent["seconds"][key] += time.perf_counter() - t0

    def _maybe_spool(self, table: str, ent: dict, force: bool = False):
        """Persist the applied state BEFORE the op acks, so a killed shard
        loses only unacked/queued puts (never an acknowledged apply)."""
        if self.spool_dir is None or self.spool_every <= 0:
            return
        if not force and ent["puts"] % self.spool_every != 0:
            return
        with self._timed(ent, "spool"):
            self._spool(table, ent)

    def _spool(self, table: str, ent: dict):
        root = os.path.join(self.spool_dir, table)
        os.makedirs(root, exist_ok=True)
        ent["spool_gen"] = ent.get("spool_gen", 0) + 1
        gen = f"gen_{ent['spool_gen'] % 2}"            # two alternating slots
        d = os.path.join(root, gen)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.makedirs(d)
        _write_blob(d, ent["backend"].state_for_checkpoint(ent["state"]))
        tmp = os.path.join(root, ".current_tmp")
        with open(tmp, "w") as f:
            f.write(gen)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(root, "CURRENT"))

    def _ensure_queue(self, ent: dict, width: int):
        """Lazy queue creation: a hybrid put arriving with no queue (fresh
        configure, or post-restore) creates one at the width the client's
        queue has (the router's width for a shard of a sharded table)."""
        if ent["queue"] is None and ent["spec"].staleness > 0 and width > 0:
            ent["queue"] = ent["backend"]._queue_init_width(int(width),
                                                            self.device)

    def _ids(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int32)).to(self.device)

    def _grads_in(self, grads) -> torch.Tensor:
        return torch.from_numpy(wire.lossy_unpack(grads)).to(self.device)

    def _acts_out(self, ent: dict, acts: torch.Tensor):
        acts = acts.float().cpu().numpy()
        if ent["lossy"]:
            return wire.lossy_pack(acts, ent["spec"].wire_block)
        return acts

    def _state_from_numpy(self, backend, st: dict) -> dict:
        """A backend's state as numpy (a restore's, a seed's) -> tensors
        on the server's device."""
        from repro_torch.convert import table_from_numpy
        return table_from_numpy(backend, st, self.device)

    # -- ops -----------------------------------------------------------------

    def _op_ping(self):
        return {"pid": os.getpid(), "tables": sorted(self._tables),
                "device": str(self.device)}

    def _op_configure(self, table: str, spec: dict, lossy: bool = False):
        with self._lock:
            s = wire.spec_from_dict(spec)
            base, wrap = BK.parse_backend_name(s.backend)
            if wrap or int(s.emb_shards) != 1:
                raise ValueError(
                    "PSServer hosts plain single-shard backends; the wire "
                    "compression and shard geometry live client-side "
                    f"(got backend={s.backend!r}, emb_shards={s.emb_shards})")
            self._tables[table] = {
                "spec": s, "backend": BK.create_backend(s), "state": None,
                "queue": None, "lossy": bool(lossy), "puts": 0,
                "seconds": dict.fromkeys(("prepare", "lookup", "read", "put",
                                          "spool"), 0.0),
            }
        return {}

    def _op_init(self, table: str, gen_state, gen_device: str,
                 scale: float = 0.02):
        with self._lock:
            ent = self._entry(table)
            if gen_device != self.device.type:
                raise ValueError(
                    f"init draws with the trainer's generator: it is on "
                    f"{gen_device!r}, this PS on {self.device.type!r} — run "
                    "the trainer and its PS processes on one device type")
            gen = torch.Generator(device=self.device)
            gen.set_state(torch.from_numpy(np.asarray(gen_state, np.uint8)))
            ent["state"] = ent["backend"].init(gen, 1, float(scale))
            ent["queue"] = None
            self._maybe_spool(table, ent, force=True)
            return {"gen_state": gen.get_state().numpy()}

    def _op_seed_rows(self, table: str, ids, vecs, accs=None):
        """Seed this shard's local rows (the router's init/reshard path):
        ids are LOCAL row ids, vecs/accs their logical values."""
        with self._lock:
            ent = self._entry(table)
            spec, backend = ent["spec"], ent["backend"]
            ids = np.asarray(ids, np.int64)
            vecs = np.asarray(vecs, np.float32)
            accs = None if accs is None else np.asarray(accs, np.float32)
            if isinstance(backend, BK.HostLRUBackend):
                ent["state"] = backend._init_with_rows(ids, vecs, accs,
                                                       self.device)
            else:
                vec = np.zeros((spec.rows, spec.dim), np.float32)
                vec[ids] = vecs
                acc = None
                if accs is not None:
                    acc = np.zeros((spec.rows,), np.float32)
                    acc[ids] = accs
                ent["state"] = self._state_from_numpy(
                    backend, BK._dense_state_from_logical(spec, spec.rows,
                                                          vec, acc))
            ent["queue"] = None
            self._maybe_spool(table, ent, force=True)
        return {}

    def _op_queue_init(self, table: str, width: int):
        with self._lock:
            ent = self._entry(table)
            ent["queue"] = None
            self._ensure_queue(ent, int(width))
        return {}

    def _op_prepare(self, table: str, ids, assume_unique: bool = False,
                    counts=None):
        with self._lock:
            ent = self._entry(table)
            backend = ent["backend"]
            with self._timed(ent, "prepare"):
                ent["state"], dev = backend.prepare(
                    ent["state"], np.asarray(ids, np.int64),
                    bool(assume_unique), counts)
            return {"dev": np.asarray(dev, np.int32),
                    "faults": int(getattr(backend, "faults", 0)),
                    "hits": int(getattr(backend, "hits", 0))}

    def _op_lookup(self, table: str, dev):
        with self._lock:
            ent = self._entry(table)
            with self._timed(ent, "lookup"):
                acts, _ = ent["backend"]._lookup_flat(ent["state"],
                                                      self._ids(dev))
                return {"acts": self._acts_out(ent, acts)}

    def _op_read_rows(self, table: str, ids):
        """Serve-path read: one atomic RPC resolving logical ids against
        the live state under the server lock (read-only — NOT in
        MUTATING_OPS, so a retried read never perturbs replay
        suppression). A single op replaces the prepare+lookup pair a
        client would otherwise need, closing the window where a
        concurrent trainer fault-in could recycle a slot between the two
        RPCs."""
        with self._lock:
            ent = self._entry(table)
            with self._timed(ent, "read"):
                rows, info = ent["backend"].read_rows(
                    ent["state"], np.asarray(ids, np.int64))
                return {"acts": self._acts_out(ent, rows), **info}

    def _op_put(self, table: str, dev, grads, unique: bool = False):
        with self._lock:
            ent = self._entry(table)
            backend = ent["backend"]
            with self._timed(ent, "put"):
                dev_t, g_t = self._ids(dev), self._grads_in(grads)
                if unique:
                    ent["state"], _ = backend._put_unique(ent["state"],
                                                          dev_t, g_t)
                else:
                    ent["state"], _ = backend._put_flat(ent["state"], dev_t,
                                                        g_t)
            ent["puts"] += 1
            self._maybe_spool(table, ent)
        return {}

    def _op_hybrid(self, table: str, dev, grads, width: int,
                   unique: bool = False):
        with self._lock:
            ent = self._entry(table)
            backend = ent["backend"]
            with self._timed(ent, "put"):
                dev_t, g_t = self._ids(dev), self._grads_in(grads)
                self._ensure_queue(ent, int(width))
                if unique:
                    st, q, _ = backend._hybrid_unique(
                        ent["state"], ent["queue"], dev_t, g_t)
                else:
                    st, q, _ = backend._hybrid_flat(
                        ent["state"], ent["queue"], dev_t,
                        g_t.reshape(-1, ent["spec"].dim))
                ent["state"], ent["queue"] = st, q
            ent["puts"] += 1
            self._maybe_spool(table, ent)
        return {}

    def _op_pin(self, table: str, slots):
        self._entry(table)["backend"].pin_slots(np.asarray(slots, np.int64))
        return {}

    def _op_unpin(self, table: str, slots):
        self._entry(table)["backend"].unpin_slots(np.asarray(slots, np.int64))
        return {}

    def _op_reset_pins(self, table: str):
        self._entry(table)["backend"].reset_pins()
        return {}

    def _op_checkpoint(self, table: str):
        with self._lock:
            ent = self._entry(table)
            return {"blob": ent["backend"].state_for_checkpoint(ent["state"])}

    def _op_restore(self, table: str, blob):
        with self._lock:
            ent = self._entry(table)
            backend = ent["backend"]
            ent["state"] = self._state_from_numpy(
                backend, backend.restore_from_checkpoint(blob))
            # queued puts are addressed in pre-restore geometry: drop them
            # (paper-tolerated in-flight loss); recreated lazily on first put
            ent["queue"] = None
            self._maybe_spool(table, ent, force=True)
            return {"resharded": bool(backend.last_restore_resharded)}

    def _op_export_logical(self, table: str):
        """This shard's rows in local-logical order (the live-reshard
        export): always raw fp32 — reshard must not quantize rows."""
        with self._lock:
            ent = self._entry(table)
            spec, backend = ent["spec"], ent["backend"]
            base, _ = BK.parse_backend_name(spec.backend)
            blob = backend.state_for_checkpoint(ent["state"])
            vec, acc = BK.extract_logical_rows(blob, spec, base)
            return {"vec": np.asarray(vec, np.float32),
                    "acc": None if acc is None
                    else np.asarray(acc, np.float32)}

    def _op_metrics(self, table: str | None = None):
        """One table's counters (puts, faults, hits, host bytes, the
        seconds its prepares, lookups, reads, puts and spools took here),
        and this process's kernel launch counts (``launches``)."""
        out = {"launches": ops.launch_counts()}
        if table is None:
            return out
        with self._lock:
            ent = self._entry(table)
            backend = ent["backend"]
            return {**out, "puts": ent["puts"],
                    "faults": int(getattr(backend, "faults", 0)),
                    "hits": int(getattr(backend, "hits", 0)),
                    "host_bytes": int(backend.host_bytes()),
                    "seconds": dict(ent["seconds"])}

    def _op_shutdown(self):
        threading.Timer(0.05, self.stop).start()
        return {}

    def _op_die(self):
        # fault injection for subprocess tests: vanish without a reply
        os._exit(3)


def main(argv=None):
    ap = argparse.ArgumentParser(description="embedding PS shard process")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = OS-assigned (published via --port-file)")
    ap.add_argument("--port-file", default=None,
                    help="write the bound port here (atomic) once listening")
    ap.add_argument("--spool-dir", default=None,
                    help="spool applied state here before acking puts")
    ap.add_argument("--spool-every", type=int, default=1,
                    help="spool every N applied puts (0 = off)")
    ap.add_argument("--reply-delay", type=float, default=0.0,
                    help="delay every reply by this many seconds "
                         "(injected RTT for pipelining benchmarks)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    server = PSServer(args.host, args.port, spool_dir=args.spool_dir,
                      spool_every=args.spool_every,
                      reply_delay=args.reply_delay,
                      device=args.device).start()
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(server.port))
        os.replace(tmp, args.port_file)
    print(f"ps_server listening on {args.host}:{server.port} "
          f"(pid {os.getpid()}, {server.device})", flush=True)
    server.wait()


if __name__ == "__main__":
    main()
