"""Client-side remote embedding backends (port of ``repro/net/remote.py``):
the ``EmbeddingBackend`` protocol over RPC, so ``PersiaTrainer`` and
``PipelinedTrainer`` train against PS *processes* unchanged.

Where the work happens
----------------------
A remote table's rows, accumulators and staleness queue live in its PS
processes (``repro_torch.net.ps_server``); the trainer keeps the plan and
the bag. The collection-level fan-outs of ``core/backend.py`` treat every
table whose backend is ``remote`` alike:

* ``prepare_all`` submits the host_lru fault-ins (one coalesced RPC a
  table, ONE ``step_ops`` frame per endpoint), collects them, and uploads
  the plans' index arrays with every other table's in ONE copy (a dense
  remote table's device ids are its logical ids: no RPC);
* ``lookup_all`` submits every remote table's read of its plan's unique
  rows (one frame per endpoint), uploads all the rows that come back in
  ONE copy and pools them with the in-process tables' in the stage's ONE
  bag launch (``unique_bag`` with the identity for ``dev``);
* ``put_all`` runs one sum-only ``fused_backward`` launch a table (the
  unique-width sums), copies the sums to the host (one wait for the
  stream), and buffers each put on its connection; the PS applies it
  with the backend's own apply-only launch (and, in hybrid mode, pushes
  it into its queue and applies the tau-stale put that pops out).

What JAX needs ``jax.pure_callback`` / ``io_callback`` and a version
scalar for is a direct host call here: the step is eager, and the order
of a put before the next prepare or lookup comes from one connection's
serial execution on the server: every op of an endpoint is sent in
program order (a direct call flushes the coalesced buffer first) and run
in arrival order.

The wire is **pipelined** (see :mod:`repro_torch.net.rpc`): a put does not
wait for its ack. It is buffered into the connection's coalescing buffer
and acknowledged asynchronously, bounded by a per-table **outstanding-ack
window** (sync tables 1; hybrid windows capped at the staleness bound
tau, so the updates at risk never exceed what the bounded-staleness
protocol tolerates). ``sync(state)`` drains a table's window.
``pipelined=False`` is the blocking baseline: every op one synchronous
round trip. Endpoint connections are shared through a refcounted client
pool, so a trainer's tables coalesce into O(shards) frames a step.

Numerics
--------
The server hosts the port's own dense/host_lru backend and runs the same
ops, so training over ``RemoteBackend`` with the raw fp32 wire is
bit-exact with the in-process backend, and ``RemoteShardedBackend`` with
the in-process router of its shard count (the sum-only / apply-only split
is the router's own). With ``lossy=True`` the wire carries blockscale
fp16 payloads (get rows and put sums, never reshard or seed rows),
compressed with the numpy codec of :mod:`repro_torch.net.wire` over the
same arrays the in-process ``+compressed`` wire roundtrips through the
CUDA codec, so a one-endpoint lossy table is bit-exact with in-process
``dense+compressed``. (A sharded lossy table compresses each shard's rows
on its own, so its block boundaries differ from the in-process wire's.)
On the raw wire a table sends only its plan's valid entries (a shard only
its own), in the plan's order.

State
-----
A remote table's state in the ``TrainState`` is an empty dict (a router
table's: one per shard): nothing of it lives in the trainer. Its queue is
a placeholder that takes no memory: ``ids`` (and host_lru ``slots``) of
-1 and zero ``grads``, expanded from one element to the queue's (tau,
width) shape, with ``ptr`` and ``filled`` counting the puts the PS queue
holds, so the serving staleness gauge reads it as it reads an
in-process queue and a checkpoint restores into an in-process trainer
(with the pending puts dropped, as in the JAX package).

Under a mesh
------------
A remote table built under a mesh of more than one rank
(``connect_remote_backends`` inside ``utils.set_mesh``) keeps one
process's op stream to the PS. The mesh's first rank (the leader) alone
holds the connections and sends every op: the configure, the init (the
others take the generator's state it gets back), the queue's creation at
the global batch's width, the prepare of the global batch's ids, one
lookup of the global batch's unique rows, one put of the global
deduplicated sums a table and step (``core/backend.py``'s
``prepare_all``, ``_remote_lookup_mesh``, ``_remote_puts_mesh``). The
others hold no connection; the fan-outs send them the leader's results
(``utils.from_rank0``), and their queue placeholders turn as the PS's
queue does. A serve read is collective: the leader reads every rank's
block, one read each, and sends each rank its own.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.core import backend as BK
from repro_torch.core import compression as C
from repro_torch.core import dedup as D
from repro_torch.core.backend import EmbeddingBackend, ShardedBackend, _prod
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.net import wire
from repro_torch.net.rpc import PSUnavailableError, RpcClient, RpcError

DEFAULT_MAX_PUT_WINDOW = 8     # hybrid ack-window cap (min'd with tau)
_AUX_WINDOW = 64               # outstanding pin/unpin acks before reaping

# ---------------------------------------------------------------------------
# Shared per-endpoint clients: every table/shard talking to the same PS
# process multiplexes ONE pipelined connection, so coalesced ops from all
# of a trainer's tables ride the same step_ops frame. Refcounted so a
# reshard (which closes and rebuilds sub-backends) tears the connection
# down only when its last user is gone.
# ---------------------------------------------------------------------------

_POOL_LOCK = threading.Lock()
_CLIENT_POOL: dict[tuple, list] = {}     # endpoint -> [client, refcount]


def _acquire_client(endpoint, timeout: float, retries: int,
                    backoff: float) -> RpcClient:
    ep = (str(endpoint[0]), int(endpoint[1]))
    with _POOL_LOCK:
        ent = _CLIENT_POOL.get(ep)
        if ent is None or ent[0]._closing:
            ent = [RpcClient(ep[0], ep[1], timeout=timeout,
                             retries=retries, backoff=backoff), 0]
            _CLIENT_POOL[ep] = ent
        ent[1] += 1
        return ent[0]


def _release_client(client: RpcClient):
    with _POOL_LOCK:
        ep = (client.host, client.port)
        ent = _CLIENT_POOL.get(ep)
        if ent is None or ent[0] is not client:
            client.close()
            return
        ent[1] -= 1
        if ent[1] <= 0:
            del _CLIENT_POOL[ep]
            client.close()


def _leader():
    """(the mesh in scope if it has more than one rank, else None; whether
    this process holds the PS connections: no such mesh, or its first
    rank)."""
    mesh = BK.get_mesh()
    if mesh is None or mesh.n_ranks == 1:
        return None, True
    return mesh, mesh.rank == 0


def _from_leader(mesh, obj):
    """The leader's ``obj`` on every rank of ``mesh`` (the mesh in scope,
    or the one the backend was built under when a caller takes it out of
    scope, as a global state's conversion does); ``obj`` itself without
    one."""
    import torch.distributed as dist
    m = BK.get_mesh()
    m = m if m is not None and m.n_ranks > 1 else mesh
    if m is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=m.get_group(m.axis_names))
    return box[0]


def _batch_ranks(mesh) -> int:
    """The ranks the mesh cuts the batch over (1 without one)."""
    return 1 if mesh is None else mesh.axis_size(
        tuple(a for a in ("pod", "data") if a in mesh.axis_names))


def _is_blob(x) -> bool:
    """A table's state as numpy that must go to the PS (a checkpoint blob,
    or a dense / host_lru state), as opposed to a remote state."""
    return isinstance(x, dict) and any(k in x for k in
                                       ("table", "store", "shard_meta"))


def _valid(ids: np.ndarray) -> np.ndarray:
    return np.flatnonzero(np.asarray(ids).reshape(-1) >= 0)


class _Remote:
    """What a remote table's two backends share: the protocol's device-side
    entry points on top of their fan-out phases (``lookup_submit``,
    ``put_sums`` / ``put_host``, ``read_submit``)."""

    remote = True

    def state_device(self, state) -> torch.device:
        return self.device

    def hybrid_update(self, state, queue, dev_ids, grads):
        return BK._remote_puts([(self, state, queue, dev_ids, grads)])[0]

    def apply_put(self, state, dev_ids, grads):
        st, _, m = self.hybrid_update(state, None, dev_ids, grads)
        return st, m

    def put_sums(self, dev_ids, grads):
        """The device half of a put -> ``(ids, sums, unique)``: a plan's
        host unique ids and their (U, dim) sums (one sum-only
        ``fused_backward`` launch); occurrence ids keep their gradients,
        grouped first on the lossy wire (which always dedups its puts) over
        this backend's whole device id space (a router's: every shard's)."""
        if D.is_plan(dev_ids):
            host = dev_ids.host if dev_ids.host is not None else dev_ids.dev
            return host, D.csr_segment_sum(*BK._plan_csr(dev_ids), grads,
                                           int(dev_ids.dev.shape[0])), True
        flat, g = dev_ids.reshape(-1), grads.reshape(-1, self.spec.dim)
        if not self.lossy:
            return flat, g.float(), False
        plan = C.dedup_plan(flat, D.dedup_cap(int(flat.numel()),
                                              self.dev_rows()))
        return plan.dev, D.csr_segment_sum(plan.order, plan.offsets, g,
                                           int(plan.dev.shape[0])), True

    def lookup(self, state, dev_ids):
        if BK._on_mesh():
            m = {}
            out = BK._remote_lookup_mesh({0: self}, {0: state},
                                         {0: dev_ids})(m)[0]
            m = {k.split("/", 2)[-1]: v for k, v in m.items()}
        else:
            rows, m = self.lookup_submit(state, dev_ids)()
            out = torch.from_numpy(rows).to(BK._ids_device(dev_ids))
        if D.is_plan(dev_ids):
            return D.plan_scatter(out, dev_ids.inv), m
        return out.reshape(*dev_ids.shape, self.spec.dim), m

    def lookup_pooled(self, state, dev_ids):
        pooled, m = BK.lookup_all({0: self}, {0: state}, {0: dev_ids})
        return pooled[0], m

    def _read_begin(self, arr, occ=False):
        return self.read_submit(arr, occ)()

    def read_submit(self, arr: np.ndarray, occ: bool = False):
        """Buffer a serve read of LOGICAL ids ``arr``; the thunk returns
        ``_read_begin``'s triple. Under a mesh it is a collective: every
        rank submits its own block of requests (blocks of one shape), the
        first rank reads every rank's block (one read each, as that rank
        alone would) and sends each rank its own."""
        mesh = BK.get_mesh()
        if mesh is None or mesh.n_ranks == 1:
            return self._read_one(arr, occ)
        arr = np.asarray(arr, np.int64)
        got = BK.all_gather(torch.from_numpy(arr.reshape(1, -1)).to(
            mesh.device), mesh.axis_names).cpu().numpy()
        thunks = [self._read_one(a.reshape(arr.shape), occ) for a in got] \
            if mesh.rank == 0 else None

        def collect():
            res = BK.from_rank0([t() for t in thunks] if thunks else None)
            return res[mesh.rank]
        return collect


class RemoteBackend(_Remote, EmbeddingBackend):
    """One table (or one shard of a table) behind a PS process."""

    def __init__(self, spec: EmbeddingSpec, endpoint, table: str = "t",
                 lossy: bool = False, timeout: float = 30.0,
                 retries: int = 3, backoff: float = 0.2,
                 put_window: int | None = None, pipelined: bool = True,
                 device: str | torch.device = "cuda"):
        base, wrap = BK.parse_backend_name(spec.backend)
        if wrap:
            raise ValueError(
                "RemoteBackend compresses on the wire itself: pass "
                "lossy=True instead of a '+compressed' backend suffix")
        if int(spec.emb_shards) != 1:
            raise ValueError(
                "RemoteBackend is one PS shard; shard via "
                "RemoteShardedBackend over multiple endpoints")
        if base.startswith("host_lru") and spec.cache_rows <= 0:
            raise ValueError(
                "host_lru backend needs EmbeddingSpec.cache_rows > 0 "
                f"(got {spec.cache_rows})")
        self.spec = spec
        self.device = torch.device(device)
        self._host = base.startswith("host_lru")
        self.cache_rows = int(spec.cache_rows)
        # mirror the PS-side slot-pool size (main cache + admission bypass
        # region): device ids returned by the remote prepare live in
        # [0, dev_slots), not [0, cache_rows)
        bypass = ((int(spec.bypass_rows) or max(1, self.cache_rows // 4))
                  if spec.admit_threshold > 0 else 0)
        self.dev_slots = self.cache_rows + bypass
        self.lossy = bool(lossy)
        self._block = int(spec.wire_block)
        self._table = str(table)
        # under a mesh of more than one rank in scope at construction, the
        # mesh's first rank alone holds the PS connection (the leader)
        self._mesh, self._lead = _leader()
        self._client = _acquire_client(endpoint, timeout, retries,
                                       backoff) if self._lead else None
        # outstanding-ack window: sync tables 1 (one unacked put at most);
        # hybrid tables up to tau (in-flight loss stays within the paper's
        # bounded-staleness tolerance), capped at DEFAULT_MAX_PUT_WINDOW
        self._pipelined = bool(pipelined)
        if put_window is None:
            tau = int(spec.staleness)
            put_window = 1 if tau <= 0 else max(
                1, min(tau, DEFAULT_MAX_PUT_WINDOW))
        if not self._pipelined:
            put_window = 1      # blocking baseline: one synchronous RTT/op
        self.put_window = max(1, int(put_window))
        self._acks: deque = deque()       # outstanding put-ack futures
        self._aux: deque = deque()        # outstanding pin/unpin acks
        self.faults = 0           # host_lru fault/hit mirrors (shard gauges)
        self.hits = 0
        self._queue_width_cfg = 0
        if self._lead:
            self._call("configure", _mutating=True,
                       spec=wire.spec_to_dict(spec), lossy=self.lossy)

    # -- plumbing ------------------------------------------------------------

    @property
    def endpoint(self):
        return self._client.endpoint

    def _not_lead(self, op: str):
        """A PS op asked of a rank of the mesh that holds no connection."""
        return RuntimeError(
            f"{op!r} on a remote table of the mesh's rank {self._mesh.rank}: "
            "the mesh's first rank alone sends the PS ops (core/backend.py's "
            "fan-outs share its results)")

    def _call(self, op: str, _mutating: bool = False, **kw):
        if not self._lead:
            raise self._not_lead(op)
        return self._client.call(op, _mutating=_mutating, table=self._table,
                                 **kw)

    def _coal(self, op: str, _mutating: bool = False, **kw) -> Future:
        if not self._lead:
            raise self._not_lead(op)
        if not self._pipelined:
            # blocking-baseline preset (the benchmark's comparison bar):
            # every op is its own synchronous round-trip, no coalescing —
            # the pre-pipelining wire path, behind the same interface
            fut: Future = Future()
            try:
                fut.set_result(self._call(op, _mutating=_mutating, **kw))
            except Exception as e:              # noqa: BLE001
                fut.set_exception(e)
            return fut
        return self._client.coalesce(op, _mutating=_mutating,
                                     table=self._table, **kw)

    def _result(self, fut: Future):
        self._client.flush()
        return self._client.result(fut)

    def close(self):
        self.discard_pending()
        if self._client is not None:
            _release_client(self._client)

    def discard_pending(self):
        """Drop outstanding ack futures without raising — the membership
        -change path: unacked in-flight puts on a dead shard are the
        paper's tolerated loss, not an error to surface."""
        self._acks.clear()
        self._aux.clear()

    def _reap(self, q: deque, limit: int):
        """Pop completed futures (raising their errors) and block the
        window down to ``limit`` outstanding."""
        while q and q[0].done():
            err = q.popleft().exception()
            if err is not None:
                raise err
        while len(q) > limit:           # (only the leader holds acks)
            self._client.flush()            # oldest may still be buffered
            err = None
            try:
                self._client.result(q[0])
            except Exception as e:          # noqa: BLE001
                err = e
            q.popleft()
            if err is not None:
                raise err

    def sync(self, state):
        """Drain this table's window: block until every put sent for it
        has been ACKed by the PS."""
        self._reap(self._acks, 0)
        self._reap(self._aux, 0)
        return state

    def adopt(self, emb_np):
        """A table's state as numpy -> its remote state: a checkpoint blob
        or a dense / host_lru state is restored into the PS; a remote
        state is itself."""
        return self.restore_from_checkpoint(emb_np) if _is_blob(emb_np) \
            else emb_np

    # -- host-level ----------------------------------------------------------

    def init(self, generator: torch.Generator, shards: int = 1,
             scale: float = 0.02):
        """The PS draws the table from ``generator``'s state, as the
        in-process backend draws it, and hands the advanced state back."""
        if shards != 1:
            raise ValueError(
                "RemoteBackend is one PS shard; shard via "
                f"RemoteShardedBackend (got shards={shards})")
        rep = self._call("init", _mutating=True,
                         gen_state=generator.get_state().numpy(),
                         gen_device=generator.device.type,
                         scale=float(scale)) if self._lead else None
        rep = _from_leader(self._mesh, rep)
        generator.set_state(torch.from_numpy(
            np.asarray(rep["gen_state"], np.uint8)))
        return {}

    def seed_rows(self, ids, vecs, accs=None):
        """Seed this shard's local rows (router init / reshard path)."""
        if self._lead:
            self._call("seed_rows", _mutating=True,
                       ids=np.asarray(ids, np.int64),
                       vecs=np.asarray(vecs, np.float32),
                       accs=None if accs is None
                       else np.asarray(accs, np.float32))
        return {}

    def prepare(self, state, ids, assume_unique: bool = False, counts=None):
        return self.prepare_submit(state, ids, assume_unique, counts)()

    def prepare_submit(self, state, ids, assume_unique: bool = False,
                       counts=None):
        """Buffer the fault-in into the connection's coalescing buffer (it
        rides the same ``step_ops`` frame as the buffered puts, which the
        server applies first) and return a thunk that collects ``(state,
        dev_ids)``, host int32 (a tensor on the trainer's device for a
        tensor). A dense table's ids are its device ids: no RPC."""
        if not self._host:
            return lambda: (state, ids)
        self._reap(self._acks, self.put_window)   # surface deferred errors
        fut = self._coal("prepare", ids=BK._host_ids(ids),
                         assume_unique=bool(assume_unique),
                         counts=None if counts is None
                         else np.asarray(counts, np.int64))

        def collect():
            rep = self._result(fut)
            self.faults, self.hits = int(rep["faults"]), int(rep["hits"])
            dev = np.asarray(rep["dev"], np.int32)
            if isinstance(ids, torch.Tensor):
                return state, torch.from_numpy(dev).to(self.device)
            return state, dev
        return collect

    def dedup_rows(self) -> int:
        return min(self.spec.rows, self.cache_rows) if self._host \
            else self.spec.rows

    def dev_rows(self) -> int:
        return self.dev_slots if self._host else self.spec.rows

    def queue_width(self, n_occ: int) -> int:
        if self.lossy:
            # the lossy wire ALWAYS dedups its puts (CompressedWireBackend's
            # width rule, mirrored so queue widths agree)
            return D.dedup_cap(int(n_occ), self.dev_rows())
        return super().queue_width(n_occ)

    def queue_init(self, ids_shape, device=None):
        if self.spec.staleness <= 0:
            return None
        return self._queue_init_width(self.queue_width(_prod(ids_shape)))

    def _queue_init_width(self, width: int, device=None):
        # width 0 = "re-derive" (a resharded restore of a placeholder):
        # fall back to the last configured width; the server also
        # re-creates its queue lazily at the first put's width. Under a
        # mesh the placeholder is the rank's share of the queue, the PS's
        # queue the global batch's
        width = int(width) or self._queue_width_cfg
        self._queue_width_cfg = int(width)
        if self._lead:
            self._call("queue_init", _mutating=True,
                       width=int(width) * _batch_ranks(self._mesh))
        return self._placeholder(width, 0, 0)

    def _placeholder(self, width: int, ptr: int, filled: int) -> dict:
        """The client-side queue: no memory (one element expanded to the
        queue's shape), ``ptr``/``filled`` those of the PS queue."""
        spec, tau = self.spec, self.spec.staleness
        ids = torch.full((), -1, dtype=torch.int32,
                         device=self.device).expand(tau, int(width))
        q = {"ids": ids,
             "grads": torch.zeros((), dtype=spec.dtype, device=self.device)
             .expand(tau, int(width), spec.dim),
             "ptr": int(ptr), "filled": int(filled)}
        if self._host:
            q["slots"] = ids
        return q

    def pin_slots(self, dev_ids):
        if self._host and self._lead:
            self._reap(self._aux, _AUX_WINDOW)
            self._aux.append(self._coal(
                "pin", _mutating=True, slots=self._pin_host(dev_ids)))

    def unpin_slots(self, dev_ids):
        if self._host and self._lead:
            self._reap(self._aux, _AUX_WINDOW)
            self._aux.append(self._coal(
                "unpin", _mutating=True, slots=self._pin_host(dev_ids)))

    def reset_pins(self):
        if self._host and self._lead:
            self._reap(self._aux, _AUX_WINDOW)
            self._aux.append(self._coal("reset_pins", _mutating=True))

    @staticmethod
    def _pin_host(dev_ids) -> np.ndarray:
        host = dev_ids.host if D.is_plan(dev_ids) else None
        return BK._host_ids(D.plan_dev(dev_ids) if host is None
                            else host).reshape(-1)

    # -- checkpoint / reshard -------------------------------------------------

    def state_for_checkpoint(self, state):
        self.sync(state)
        return self._call("checkpoint")["blob"]

    def restore_from_checkpoint(self, blob):
        rep = _from_leader(self._mesh, self._call(
            "restore", _mutating=True, blob=blob) if self._lead else None)
        self.last_restore_resharded = bool(rep["resharded"])
        return {}

    def export_logical(self):
        """(vec, acc) of this shard's local rows — always raw fp32 (the
        reshard path must not quantize)."""
        rep = self._call("export_logical")
        acc = rep["acc"]
        return (np.asarray(rep["vec"], np.float32),
                None if acc is None else np.asarray(acc, np.float32))

    def remote_metrics(self) -> dict:
        return self._call("metrics")

    def device_bytes(self, state) -> int:
        return 0      # the PS process owns the rows, not this client

    def host_bytes(self) -> int:
        return 0

    # -- the wire ops on host arrays ------------------------------------------

    def _lookup_rpc(self, dev: np.ndarray) -> Future:
        """Buffer a read of the rows of device ids ``dev`` (1-D host)."""
        return self._coal("lookup", dev=np.asarray(dev, np.int32))

    def _rows_of(self, fut: Future, n: int) -> tuple[np.ndarray, int]:
        """A read's reply -> ((n, dim) fp32 rows, wire bytes)."""
        acts = self._result(fut)["acts"]
        rows = wire.lossy_unpack(acts).astype(np.float32, copy=False)
        return rows.reshape(n, self.spec.dim), wire.payload_nbytes(acts)

    def _put_rpc(self, op: str, dev: np.ndarray, g: np.ndarray, unique: bool,
                 width: int) -> int:
        """Windowed async put: buffer the op (coalesced into the next
        ``step_ops`` frame) and return its wire bytes — the ack resolves
        in the io thread. At most ``put_window`` acks stay outstanding; a
        full window blocks on (and re-raises errors from) the oldest."""
        dev = np.asarray(dev, np.int32)
        payload = wire.lossy_pack(g, self._block) if self.lossy \
            else np.asarray(g, np.float32)
        self._reap(self._acks, self.put_window - 1)
        kw = {"width": int(width)} if op == "hybrid" else {}
        self._acks.append(self._coal(op, _mutating=True, dev=dev,
                                     grads=payload, unique=unique, **kw))
        return dev.nbytes + wire.payload_nbytes(payload)

    # -- the fan-outs' phases (core/backend.py) -------------------------------

    def _lookup_ids(self, dev_ids) -> tuple[np.ndarray, np.ndarray, bool]:
        """The host device ids a lookup reads -> (all of them, the
        positions sent, plan?): a plan's unique ids (its valid ones on the
        raw wire; all of them on the lossy wire, whose codec blocks run
        over the plan's padded rows as the in-process wire's do), else
        the occurrence ids (a copy from the device)."""
        if D.is_plan(dev_ids):
            host = np.asarray(dev_ids.host if dev_ids.host is not None
                              else dev_ids.dev.cpu().numpy(), np.int32)
            sent = np.arange(host.size) if self.lossy else _valid(host)
            return host, sent, True
        host = dev_ids.detach().cpu().numpy().astype(np.int32).reshape(-1)
        return host, np.arange(host.size), False

    def lookup_submit(self, state, dev_ids):
        """Buffer the read of a lookup's rows; the thunk returns ``((N,
        dim) fp32 host rows, wire metrics)``: a plan's unique rows (zero
        rows at its padding), else the occurrence rows."""
        host, sent, _ = self._lookup_ids(dev_ids)
        fut = self._lookup_rpc(host[sent])

        def collect():
            rows = np.zeros((host.size, self.spec.dim), np.float32)
            got, n_wire = self._rows_of(fut, sent.size)
            rows[sent] = got
            return rows, self._get_metrics(host, sent, n_wire)
        return collect

    def _get_metrics(self, host, sent, n_wire) -> dict:
        return {"get_bytes_raw": float(host.size * (4 + 4 * self.spec.dim)),
                "get_bytes_wire": float(sent.size * 4 + n_wire)}

    def put_host(self, state, queue, ids, sums, unique: bool):
        """The host half of a put (``ids``/``sums`` host numpy): buffer it
        on the connection -> ``(state, queue, metrics)``."""
        return self._put_host(queue, np.asarray(ids, np.int32).reshape(-1),
                              np.asarray(sums, np.float32), unique)

    def _put_host(self, queue, ids, g, unique):
        """Buffer a put: a put of unique ids sends its valid entries on the
        raw wire, all of them on the lossy wire (the codec's blocks run
        over the padded sums, as the in-process wire's do)."""
        hybrid = self.spec.staleness > 0 and queue is not None
        sent = _valid(ids) if unique and not self.lossy \
            else np.arange(ids.size)
        n_wire = self._put_rpc("hybrid" if hybrid else "put", ids[sent],
                               g[sent], unique,
                               int(queue["ids"].shape[1]) if hybrid else 0)
        m = {"put_bytes_raw": float(ids.size * (4 + 4 * self.spec.dim)),
             "put_bytes_wire": float(n_wire)}
        return {}, self.pushed(queue), m

    def counters(self) -> tuple:
        """The PS's fault and hit counters as the last prepare saw them."""
        return self.faults, self.hits

    def set_counters(self, got):
        self.faults, self.hits = got

    def pushed(self, queue):
        """The queue placeholder after one more push into the PS queue."""
        if self.spec.staleness <= 0 or queue is None:
            return queue
        tau = self.spec.staleness
        return self._placeholder(int(queue["ids"].shape[1]),
                                 (int(queue["ptr"]) + 1) % tau,
                                 min(int(queue["filled"]) + 1, tau))


    # -- serve-path reads -----------------------------------------------------

    def _read_one(self, arr: np.ndarray, occ: bool = False):
        """Buffer a serve read of LOGICAL ids ``arr`` (one atomic RPC under
        the server's lock); the thunk returns ``_read_begin``'s triple.
        The raw wire reads the unique ids (rows ``(U, dim)``, at least
        one, and the inverse); the lossy wire reads the occurrence rows,
        as the in-process wire's read roundtrips them, pooled through
        their slots."""
        arr = np.asarray(arr, np.int64)
        flat = arr.reshape(-1)
        if self.lossy:
            fut = self._coal("read_rows", ids=flat)

            def collect_occ():
                rep = self._result(fut)
                rows = wire.lossy_unpack(rep["acts"]).astype(np.float32)
                idx = np.arange(flat.size, dtype=np.int32).reshape(
                    arr.shape) if occ else BK._host_slots(arr)
                return ([idx], rows.reshape(flat.size, self.spec.dim),
                        _info(rep))
            return collect_occ
        valid = (flat >= 0) & (flat < self.spec.rows)
        uniq, inv_valid = np.unique(flat[valid], return_inverse=True)
        inv = np.full(flat.shape, -1, np.int32)
        inv[valid] = inv_valid
        fut = self._coal("read_rows", ids=uniq)

        def collect():
            rep = self._result(fut)
            rows = np.zeros((max(uniq.size, 1), self.spec.dim), np.float32)
            rows[:uniq.size] = wire.lossy_unpack(rep["acts"]).reshape(
                uniq.size, self.spec.dim)
            return [inv.reshape(arr.shape)], rows, _info(rep)
        return collect


    def _read_end(self, state, idx, rows, occ=False):
        if occ:
            return D.plan_scatter(rows, idx[0])
        return (rows, None, idx[0], self.lossy)


def _info(rep: dict) -> dict:
    return {k: int(rep[k]) for k in ("reads", "hits", "misses")}


class RemoteShardedBackend(_Remote, ShardedBackend):
    """The in-process sharded router with every shard behind an RPC
    endpoint: routing, concurrent per-shard prepare, shard-encoded device
    ids, shard-tagged checkpoints and N->M restore resharding are all
    inherited — only the sub-backend factory and the device side change
    (a lookup gathers each shard's rows over the wire into one block of
    the plan's unique rows; a put sends each shard its own rows of the
    unique sums, every step, so its queue turns as the in-process
    shard's does). Adds :meth:`reshard_live` (elastic leave/join:
    redistribute logical rows over a new member set mid-run)."""

    min_shards = 1       # one PS process is still a remote deployment

    def __init__(self, spec: EmbeddingSpec, endpoints, lossy: bool = False,
                 table: str = "t", timeout: float = 30.0, retries: int = 3,
                 backoff: float = 0.2, put_window: int | None = None,
                 pipelined: bool = True,
                 device: str | torch.device = "cuda"):
        self._endpoints = [tuple(e) for e in endpoints]
        if not self._endpoints:
            raise ValueError("RemoteShardedBackend needs >= 1 endpoint")
        self.lossy = bool(lossy)
        self.device = torch.device(device)
        self._table = str(table)
        self._rpc_opts = {"timeout": timeout, "retries": retries,
                          "backoff": backoff, "put_window": put_window,
                          "pipelined": pipelined, "device": self.device}
        self._queue_width_cfg = 0
        self.last_reshard_lost_rows = 0
        super().__init__(dataclasses.replace(
            spec, emb_shards=len(self._endpoints)))

    def _make_sub(self, s: int, sub_spec: EmbeddingSpec) -> RemoteBackend:
        return RemoteBackend(sub_spec, self._endpoints[s], table=self._table,
                             lossy=self.lossy, **self._rpc_opts)

    def _configure(self, k: int):
        if k != len(self._endpoints):
            raise ValueError(
                f"RemoteShardedBackend has {len(self._endpoints)} endpoints "
                f"but was asked for {k} shards; change membership via "
                "reshard_live(new_endpoints)")
        for sub in getattr(self, "shard_backends", ()):
            sub.close()
        super()._configure(k)


    def adopt(self, emb_np):
        """As :meth:`RemoteBackend.adopt`; the shards' states as numpy
        (``{"s0": .., }``) restore shard by shard."""
        if isinstance(emb_np, dict) and "s0" in emb_np and \
                _is_blob(emb_np["s0"]):
            emb_np = {"shard_meta": np.array([len(emb_np), self.spec.rows,
                                              self.spec.dim], np.int64),
                      "shards": emb_np}
        return self.restore_from_checkpoint(emb_np) if _is_blob(emb_np) \
            else emb_np

    def close(self):
        for sub in self.shard_backends:
            sub.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def sync(self, state):
        # flush every shard's buffer first so the ack waits overlap across
        # shards instead of paying one serial round-trip each
        for sub in self.shard_backends:
            if sub._client is not None:
                sub._client.flush()
        for s, sub in enumerate(self.shard_backends):
            sub.sync(state[f"s{s}"])
        return state

    def discard_pending(self):
        """Drop every shard's outstanding ack futures (membership change:
        in-flight unacked puts are the tolerated loss, not an error)."""
        for sub in self.shard_backends:
            sub.discard_pending()

    # -- seeding / queues over RPC --------------------------------------------

    def _sub_states_from_logical(self, vec, acc, device=None):
        r = self._routing
        ids = np.arange(self.spec.rows)
        own, loc = r.shard_and_local(ids)

        def seed(s):
            sel = own == s
            return self.shard_backends[s].seed_rows(
                loc[sel], np.asarray(vec[sel], np.float32),
                None if acc is None else np.asarray(acc[sel], np.float32))

        pool = self._ensure_pool()
        futs = [pool.submit(seed, s) for s in range(self.n_shards)]
        return {f"s{s}": f.result() for s, f in enumerate(futs)}

    def _queue_init_width(self, width: int, device=None):
        width = int(width) or self._queue_width_cfg
        self._queue_width_cfg = int(width)
        return super()._queue_init_width(width)

    def queue_width(self, n_occ: int) -> int:
        if self.lossy:
            return D.dedup_cap(int(n_occ), self.dev_rows())
        return super().queue_width(n_occ)

    def pushed(self, queue):
        if queue is None:
            return None
        return {f"s{s}": sub.pushed(queue[f"s{s}"])
                for s, sub in enumerate(self.shard_backends)}

    def counters(self) -> list:
        return [sub.counters() for sub in self.shard_backends]

    def set_counters(self, got):
        for sub, c in zip(self.shard_backends, got):
            sub.set_counters(c)

    # -- the fan-outs' phases -------------------------------------------------

    def _owners(self, host: np.ndarray):
        """Shard-encoded device ids -> (owner, -1 where invalid; local)."""
        dev = np.asarray(host, np.int64).reshape(-1)
        ok = (dev >= 0) & (dev < self.dev_rows())
        return np.where(ok, dev // self.stride, -1), dev % self.stride

    def lookup_submit(self, state, dev_ids):
        """Every shard's read of its own rows of the lookup, buffered on
        its endpoint; the thunk scatters them into one host block."""
        sub0 = self.shard_backends[0]
        host, _, _ = sub0._lookup_ids(dev_ids)
        own, loc = self._owners(host)
        parts = []
        for s, sub in enumerate(self.shard_backends):
            sel = np.flatnonzero(own == s)
            parts.append((sel, sub._lookup_rpc(loc[sel])))

        def collect():
            rows = np.zeros((host.size, self.spec.dim), np.float32)
            n_wire = 0
            for (sel, fut), sub in zip(parts, self.shard_backends):
                got, nb = sub._rows_of(fut, sel.size)
                rows[sel] = got
                n_wire += nb
            return rows, sub0._get_metrics(host, _valid(host), n_wire)
        return collect

    def put_host(self, state, queue, ids, sums, unique: bool):
        """Each shard's own rows of the put, buffered on its endpoint (an
        occurrence-width put: the full width, -1 where another shard owns
        the id), every shard every step."""
        if queue is not None and "s0" not in queue:
            raise ValueError(
                "a sharded remote table takes its shards' queues ({'s0': "
                "...}); this queue has another geometry — restore through "
                "PersiaTrainer.restore or start from queue_init")
        ids = np.asarray(ids, np.int32).reshape(-1)
        g = np.asarray(sums, np.float32)
        own, loc = self._owners(ids)
        new_state, new_queue = dict(state), dict(queue or {})
        m = {"put_bytes_raw": 0.0, "put_bytes_wire": 0.0}
        for s, sub in enumerate(self.shard_backends):
            q = None if queue is None else queue.get(f"s{s}")
            if unique:
                sel = np.flatnonzero(own == s)
                args = (loc[sel].astype(np.int32), g[sel], True)
            else:
                args = (np.where(own == s, loc, -1).astype(np.int32), g,
                        False)
            new_state[f"s{s}"], new_queue[f"s{s}"], ms = sub._put_host(
                q, *args)
            for k in m:
                m[k] += ms[k]
        if queue is None:
            new_queue = None
        return new_state, new_queue, m


    def _read_one(self, arr: np.ndarray, occ: bool = False):
        """A serve read routed over the shards: every shard reads its own
        unique ids (one RPC each, buffered on its endpoint); the thunk
        merges them into the read's unique rows, as ``_read_begin``."""
        arr = np.asarray(arr, np.int64)
        flat = arr.reshape(-1)
        valid = (flat >= 0) & (flat < self.spec.rows)
        uniq, inv_valid = np.unique(flat[valid], return_inverse=True)
        inv = np.full(flat.shape, -1, np.int32)
        inv[valid] = inv_valid
        own, loc = self._route(uniq)
        futs = [(np.flatnonzero(own == s), sub._coal(
            "read_rows", ids=loc[own == s]))
            for s, sub in enumerate(self.shard_backends)]

        def collect():
            rows = np.zeros((max(uniq.size, 1), self.spec.dim), np.float32)
            info = {"reads": int(uniq.size), "hits": 0, "misses": 0}
            for (sel, fut), sub in zip(futs, self.shard_backends):
                rep = sub._result(fut)
                rows[sel] = wire.lossy_unpack(rep["acts"]).reshape(
                    sel.size, self.spec.dim)
                info["hits"] += int(rep["hits"])
                info["misses"] += int(rep["misses"])
            return [inv.reshape(arr.shape)], rows, info
        return collect


    def _read_end(self, state, idx, rows, occ=False):
        if occ:
            return D.plan_scatter(rows, idx[0])
        return (rows, None, idx[0], False)

    def device_bytes(self, state) -> int:
        return 0

    # -- elastic membership (repro_torch.net.elastic drives this) -------------

    def export_all_logical(self, dead_blobs: dict | None = None):
        """Gather the full logical table from live members (concurrently)
        plus spooled blobs for dead ones. A dead shard with no blob loses
        its rows (zero-reinit, counted in ``last_reshard_lost_rows``)."""
        dead_blobs = dead_blobs or {}
        r = self._routing
        ids = np.arange(self.spec.rows)
        own, loc = r.shard_and_local(ids)
        vec = np.zeros((self.spec.rows, self.spec.dim), np.float32)
        acc = (np.zeros((self.spec.rows,), np.float32)
               if self.spec.optimizer == "adagrad" else None)

        def export(s):
            blob = dead_blobs.get(s)
            if blob is not None:
                return BK.extract_logical_rows(
                    blob, self.shard_backends[s].spec, self._base)
            return self.shard_backends[s].export_logical()

        pool = self._ensure_pool()
        futs = [pool.submit(export, s) for s in range(self.n_shards)]
        lost = 0
        for s, f in enumerate(futs):
            sel = own == s
            try:
                v_s, a_s = f.result()
            except (PSUnavailableError, RpcError, OSError):
                lost += int(sel.sum())
                continue
            vec[sel] = v_s[loc[sel]]
            if acc is not None and a_s is not None:
                acc[sel] = a_s[loc[sel]]
        self.last_reshard_lost_rows = lost
        return vec, acc

    def reshard_live(self, endpoints, dead_blobs: dict | None = None):
        """Live N->M reshard onto ``endpoints``: export every logical row
        (survivors via RPC, dead members via their spool blobs), rebuild
        the router over the new member set, and seed each new shard.
        Returns ``(emb_state, emb_queue)`` for the table — queues restart
        empty (pending puts are addressed in the old geometry: the same
        tolerated in-flight loss as a resharded checkpoint restore)."""
        vec, acc = self.export_all_logical(dead_blobs)
        self._endpoints = [tuple(e) for e in endpoints]
        self._configure(len(self._endpoints))
        state = self._sub_states_from_logical(vec, acc)
        queue = None
        if self.spec.staleness > 0:
            # width 0 = unknown (restored placeholder): the RPC still resets
            # the PS queues and the servers re-create them lazily at the
            # next put's width
            queue = self._queue_init_width(self._queue_width_cfg)
        return state, queue


def connect_remote_backends(trainer, endpoints, lossy: bool | None = None,
                            timeout: float = 30.0, retries: int = 3,
                            backoff: float = 0.2,
                            put_window: int | None = None,
                            pipelined: bool = True,
                            tables=None) -> dict:
    """Point every table of a built ``PersiaTrainer`` (or only those
    named in ``tables``) at remote PS members.

    Call AFTER constructing the trainer and BEFORE ``init``/``restore``.
    With one endpoint each table gets a plain :class:`RemoteBackend`
    (device ids and the lossy wire then mirror the in-process plain /
    ``+compressed`` backends exactly); with several, a
    :class:`RemoteShardedBackend` over all of them. ``lossy=None``
    derives the wire from each spec's own ``+compressed`` suffix; an
    explicit bool overrides every table. The rows come back to the
    trainer's device. Returns the new backends dict (also installed on
    the trainer)."""
    endpoints = [tuple(e) for e in endpoints]
    for name, spec in trainer.collection.items():
        if tables is not None and name not in tables:
            continue
        base, wrap = BK.parse_backend_name(spec.backend)
        if spec.emb_shards > 1 and spec.emb_shards != len(endpoints):
            raise ValueError(
                f"table {name!r} declares emb_shards={spec.emb_shards} but "
                f"{len(endpoints)} PS endpoints were given — the remote "
                "shard count IS the member count")
        use_lossy = wrap if lossy is None else bool(lossy)
        sub = dataclasses.replace(spec, backend=base, emb_shards=1)
        old = trainer.backends.get(name)
        if old is not None and hasattr(old, "close"):
            old.close()
        kw = dict(lossy=use_lossy, timeout=timeout, retries=retries,
                  backoff=backoff, put_window=put_window,
                  pipelined=pipelined, device=trainer.device)
        if len(endpoints) == 1:
            trainer.backends[name] = RemoteBackend(sub, endpoints[0],
                                                   table=name, **kw)
        else:
            trainer.backends[name] = RemoteShardedBackend(
                sub, endpoints, table=name, **kw)
    return trainer.backends
