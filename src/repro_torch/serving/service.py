"""Micro-batched serving against the live trainer state (port of
``repro/serving/service.py``).

Many client threads submit single requests; an aggregator thread flushes
them as one micro-batch when either ``max_batch`` requests are queued or
the oldest has waited ``max_wait_ms`` — the paper's serving tier trades a
bounded queueing delay for batched device efficiency ("Understanding
Capacity-Driven Scale-Out Neural Recommendation Inference" grounds the
micro-batching / tail-latency framing).

The flush reads each table's pooled bags through
``PersiaTrainer.serve_lookup`` (the read-only ``read_pooled`` path, which
launches the bag kernels) against the :class:`StateCell` snapshot, then
runs the adapter's ``predict`` on them. Reads and trainer steps serialize
on the cell's lock, which also makes the staleness gauge exact: a read
under the lock sees the published step's state, plus whatever lag each
table's bounded-staleness queue holds.

A micro-batch is padded to ``max_batch`` with -1 id rows, so a flush's
GEMM shapes do not depend on how full it is.

Under a mesh of more than one rank (``utils.set_mesh``; the JAX package's
service reads through the mesh in scope) the serve read and the training
step are collectives: every rank must run them at the same moment, with
blocks of one shape. The service started under such a mesh therefore runs
a turn protocol instead of the free-running flush loop:

* every rank's service thread ticks on a fork of the mesh of its own
  (:meth:`utils.Mesh.fork`, its groups' timeout half ``timeout_s``): one
  ``all_reduce(MAX)`` a tick of each rank's flags (a flush is due, a train
  step is waiting and what it asks to agree on, the rank is stopping,
  requests are queued, the requests' shape), from which every rank
  decides the same next turn: a flush, a train step (only when every
  rank's trainer waits for one), both in turn when both are due, or the
  end once every rank is stopping with nothing queued;
* a flush turn takes up to ``max_batch`` of the rank's own queued
  requests (none is fine: the rank joins with -1 rows), pads them to
  ``max_batch`` rows and gathers the blocks of the ranks that share its
  batch coordinates (the ``model`` ranks of a data row: the serve read's
  spec is ``P(BATCH)``, so they must read one block); every rank of the
  row reads and predicts that block under the cell's lock and resolves
  its own rows. Every rank makes the same flushes (``serving/batches``);
* a train step runs on the trainer's thread when its turn comes
  (:meth:`ServingService.train_turn`), under the cell's lock, while the
  service thread waits for it. Only the ticks and flushes run on the
  service's fork: the step's collectives (its lookups and puts, a remote
  table's leader RPC shared by ``from_rank0``, a host_lru fault-in's
  gathers) run on the groups the trainer's thread has in scope, with the
  trainer's own timeout;
* a flush or step that raises on a rank raises
  :class:`ServingMeshError` on every rank: the failing rank posts its
  error in the process group's store and raises; the others raise when
  their next collective with it times out (a flush's: ``timeout_s / 2``;
  a step's: the trainer's groups' timeout), naming it.
  ``stop()`` waits for the agreed last turn and drains the same flushes on
  every rank.

With no mesh, or a mesh of one rank, the service and ``train_turn`` take
the one-process path.
"""
from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from repro_torch.utils import (all_gather, batch_axes, flat_index,
                               from_rank0, get_mesh, pmax, use_groups)


class StateCell:
    """Lock-protected holder of the latest published ``(TrainState, step)``.

    The trainer loop runs each step AND the publish under ``cell.lock``;
    the serving flush snapshots, reads and dispatches its predict under
    the same lock. That keeps a read from seeing a half-applied step and
    pins the snapshot's step for the staleness gauge.
    """

    def __init__(self, state=None, step: int = 0):
        self.lock = threading.RLock()
        self._state = state
        self._step = int(step)

    def publish(self, state, step: int | None = None):
        with self.lock:
            self._state = state
            self._step = int(state.step) if step is None else int(step)

    def snapshot(self):
        """(state, step) of the latest publish."""
        with self.lock:
            return self._state, self._step

    @property
    def step(self) -> int:
        with self.lock:
            return self._step


@dataclass(frozen=True)
class ServingConfig:
    """Latency-budget knobs: flush on whichever comes first."""
    max_batch: int = 16          # flush when this many requests are queued
    max_wait_ms: float = 2.0     # ... or when the oldest waited this long
    timeout_s: float = 30.0      # per-request result timeout
    latency_window: int = 8192   # ring of per-request latencies (p50/p99)


@dataclass
class _Pending:
    request: dict
    future: Future
    t_submit: float


class ServingStopTimeout(RuntimeError):
    """``stop()`` could not confirm the flush loop exited: the queue was
    deliberately NOT drained (the loop may still be flushing it)."""


class ServingMeshError(RuntimeError):
    """Under a mesh: a flush or a train step failed on a rank (or the
    ranks' turns stopped meeting). Every rank's service raises it, from
    its clients' results, its trainer's next turn and ``stop()``."""


@dataclass
class _StepTurn:
    """A train step waiting for its turn (:meth:`ServingService.
    train_turn`): what it asks every rank to agree on, and the events of
    its grant and its end."""
    agree: bool
    agreed: bool = False
    turn: int = -1
    error: BaseException | None = None

    def __post_init__(self):
        self.granted = threading.Event()
        self.done = threading.Event()


# a tick's flags, reduced with MAX over the ranks (a flag that must hold on
# every rank is sent negated): a flush is due, no train step waits, the
# waiting step's ``agree`` is False, running (not stopping), requests are
# queued; the requests' ids shape (fields, width) and dense width (-1:
# not known, no dense)
_FLUSH, _NO_STEP, _NO_AGREE, _RUNNING, _QUEUED, _SHAPE = range(6)
_TICK_S = 1e-3          # longest idle wait between two ticks


def queue_lag(q, step: int, tau: int) -> int:
    """Staleness-queue lag of one table: how many steps of applied updates
    the queue is still holding back: its ``filled`` count (0 during
    warmup, tau at steady state; a sharded router's most-filled shard
    queue). Tables without a queue lag 0."""
    if q is None or tau <= 0:
        return 0
    if "filled" not in q:                  # sharded router: per-shard queues
        return max((queue_lag(v, step, tau) for v in q.values()), default=0)
    return int(q["filled"])


class ServingService:
    """Micro-batch aggregator over a shared trainer/backend.

    >>> cell = StateCell(state, 0)
    >>> svc = ServingService(trainer, cell, ServingConfig(8, 2.0)).start()
    >>> preds = svc.predict({"ids": ids_FL, "dense": dense_nd})
    >>> svc.metrics()["serving/p99_ms"]
    >>> svc.stop()

    Requests are dicts with ``ids`` of shape (n_fields, ids_per_field)
    (int, -1 padded) and optionally ``dense`` (n_dense,). Micro-batches
    are padded to ``max_batch`` with -1 id rows so a flush's GEMM shapes
    do not depend on its fill; pad predictions are discarded.
    """

    def __init__(self, trainer, cell: StateCell,
                 config: ServingConfig | None = None):
        if trainer.adapter.predict is None:
            raise ValueError("serving needs an adapter with a predict fn")
        self.trainer = trainer
        self.cell = cell
        self.config = config or ServingConfig()
        self._cond = threading.Condition()
        self._queue: deque[_Pending] = deque()
        self._running = False
        self._thread: threading.Thread | None = None
        self._taus = {n: int(s.staleness)
                      for n, s in trainer.collection.items()}
        self._m_lock = threading.Lock()
        self._lat_ms = deque(maxlen=int(self.config.latency_window))
        self._requests = 0
        self._batches = 0
        self._errors = 0
        self._fill_sum = 0.0
        self._wait_ms_sum = 0.0
        self._t_first = None
        self._t_last = None
        self._tables = {n: {"hits": 0, "reads": 0, "stale_max": 0,
                            "stale_last": 0}
                        for n in trainer.collection.names}
        # under a mesh of more than one rank (see the module note)
        self._fork = None           # the service's fork of the mesh
        self._step: _StepTurn | None = None
        self._failure: ServingMeshError | None = None
        self._shape = (-1, -1, -1)  # (fields, width, dense) of requests
        self._turns = {"ticks": 0, "flush": 0, "step": 0}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingService":
        """Starts the flush thread. Under a mesh of more than one rank this
        is collective (every rank starts its service at once): it forks
        the mesh for the service's turns."""
        if self._thread is not None:
            raise RuntimeError("service already started")
        mesh = get_mesh()
        loop = self._loop
        if mesh is not None and mesh.n_ranks > 1:
            # half the request timeout: a failed turn reaches the clients
            # waiting on it as ServingMeshError before their own timeout
            self._fork = mesh.fork(timeout=self.config.timeout_s / 2)
            with use_groups(self._fork):
                self._key = from_rank0(uuid.uuid4().hex)
            loop = self._mesh_loop
        self._running = True
        self._thread = threading.Thread(target=loop, name="serving-flush",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._fork is not None:
            self._mesh_stop()
            return
        with self._cond:
            self._running = False
            self._cond.notify_all()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=self.config.timeout_s)
            if thread.is_alive():
                # the flush loop is stuck mid-flush (a wedged device or a
                # lock the trainer never released). Draining now would
                # race it over the same deque and double-flush — surface
                # the hang instead; queued futures will resolve if the
                # flush ever completes, or time out client-side.
                raise ServingStopTimeout(
                    f"serving flush thread still alive after "
                    f"{self.config.timeout_s}s; {len(self._queue)} queued "
                    "requests left un-drained")
        # the loop is confirmed dead: drain stragglers so no submitted
        # request is ever lost
        while True:
            with self._cond:
                take = [self._queue.popleft()
                        for _ in range(min(len(self._queue),
                                           self.config.max_batch))]
            if not take:
                break
            self._flush(take)

    def __enter__(self) -> "ServingService":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client surface ------------------------------------------------------

    def submit(self, request: dict) -> Future:
        """Enqueue one request; the future resolves to its (n_tasks,)
        fp32 prediction once its micro-batch flushes."""
        p = _Pending(request, Future(), time.monotonic())
        with self._cond:
            if self._failure is not None:
                raise self._failure
            if not self._running:
                raise RuntimeError("service not running")
            if self._fork is not None and self._shape[0] < 0:
                self._shape = _request_shape(request)
            self._queue.append(p)
            self._cond.notify_all()
        with self._m_lock:
            if self._t_first is None:
                self._t_first = p.t_submit
        return p.future

    def predict(self, request: dict, timeout: float | None = None):
        """Blocking single-request predict."""
        return self.submit(request).result(
            timeout or self.config.timeout_s)

    def predict_many(self, requests) -> np.ndarray:
        """Submit a burst and gather all results — (n, n_tasks)."""
        futs = [self.submit(r) for r in requests]
        return np.stack([f.result(self.config.timeout_s) for f in futs])

    # -- the trainer's side ---------------------------------------------------

    def train_turn(self, fn, agree: bool = True):
        """Runs ``fn(agreed)`` (a train step and its publish) as the
        trainer's next turn, under the cell's lock, and returns what it
        returns. With no mesh ``agreed`` is ``agree`` and the turn is the
        lock. Under a mesh of more than one rank every rank's trainer
        calls it for each of its steps: the step runs when every rank
        waits for one and the turn order comes to it, on the groups of
        the calling thread (not the service's fork: a step's collectives
        keep the trainer's timeout), with ``agreed`` True only where
        every rank's ``agree`` was (a choice that timing decides locally,
        such as a feedback batch over a fallback one, made the same on
        every rank). A step that raises raises :class:`ServingMeshError`
        on every rank (the others once their step's collective with it
        times out)."""
        if self._fork is None:
            with self.cell.lock:
                return fn(bool(agree))
        req = _StepTurn(bool(agree))
        with self._cond:
            if self._failure is not None:
                raise self._failure
            if not self._running or self._step is not None:
                raise RuntimeError("train_turn needs a running service and "
                                   "one trainer thread")
            self._step = req
            self._cond.notify_all()
        req.granted.wait()
        if req.error is not None:
            raise req.error
        try:
            with self.cell.lock:
                return fn(req.agreed)
        except BaseException as e:
            req.error = self._failed(f"train turn {req.turn}", e)
            raise req.error from e
        finally:
            req.done.set()

    def turn_counts(self) -> dict:
        """Under a mesh, the ticks and the flush and train turns this
        service's thread took (the same on every rank); zeros without."""
        with self._m_lock:
            return dict(self._turns)

    # -- aggregator ----------------------------------------------------------

    def _loop(self):
        cfg = self.config
        while True:
            with self._cond:
                while self._running and not self._queue:
                    self._cond.wait(timeout=0.1)
                if not self._running:
                    return
                deadline = self._queue[0].t_submit + cfg.max_wait_ms / 1e3
                while self._running and len(self._queue) < cfg.max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(timeout=left)
                take = [self._queue.popleft()
                        for _ in range(min(len(self._queue), cfg.max_batch))]
            if take:
                self._flush(take)

    # -- the turn protocol under a mesh (see the module note) ----------------

    def _mesh_stop(self):
        """Stops taking requests, waits for the agreed last turn (every
        rank's stop, every queue drained) and raises the mesh's failure,
        if any."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        if self._failure is not None:
            raise self._failure

    def _mesh_loop(self):
        last = None
        try:
            with use_groups(self._fork):
                while True:
                    got = self._tick()
                    step_due = got[_NO_STEP] == 0
                    flush_due = got[_FLUSH] == 1 or (
                        got[_RUNNING] == 0 and got[_QUEUED] == 1)
                    if step_due and flush_due:
                        kind = "flush" if last == "step" else "step"
                    elif step_due or flush_due:
                        kind = "step" if step_due else "flush"
                    elif got[_RUNNING] == 0 and got[_QUEUED] == 0:
                        return
                    else:
                        continue
                    last = kind
                    with self._m_lock:
                        self._turns[kind] += 1
                        turn = self._turns["flush"] + self._turns["step"]
                    if kind == "flush":
                        self._mesh_flush(turn, tuple(got[_SHAPE:]))
                    else:
                        self._grant(turn, got[_NO_AGREE] == 0)
        except BaseException as e:      # noqa: BLE001 -- raised on stop()
            if self._failure is None:
                self._failed("the service's turns", e)
        finally:
            with self._cond:
                self._running = False
                step, self._step = self._step, None
                take = list(self._queue)
                self._queue.clear()
            err = self._failure or ServingMeshError(
                "the service stopped before this rank's train turn")
            if step is not None and not step.granted.is_set():
                step.error = err
                step.granted.set()
            for p in take:
                p.future.set_exception(err)

    def _tick(self) -> list:
        """This rank's flags (see ``_FLUSH``..``_SHAPE``) reduced with MAX
        over the mesh: waits up to ``_TICK_S`` (or until the oldest
        request's deadline) for something to do first."""
        cfg = self.config
        with self._cond:
            until = time.monotonic() + _TICK_S
            while True:
                now = time.monotonic()
                due = bool(self._queue) and (
                    len(self._queue) >= cfg.max_batch
                    or now >= self._queue[0].t_submit + cfg.max_wait_ms / 1e3)
                if due or self._step is not None or not self._running \
                        or now >= until:
                    break
                self._cond.wait(timeout=until - now)
            step = self._step
            flags = [int(due), int(step is None),
                     int(step is None or not step.agree),
                     int(self._running), int(bool(self._queue)),
                     *self._shape]
        import torch
        import torch.distributed as dist
        g = self._fork.get_group(self._fork.axis_names)
        x = torch.tensor(flags, dtype=torch.int64, device="cpu"
                         if dist.get_backend(g) == "gloo"
                         else self._fork.device)
        with self._m_lock:
            self._turns["ticks"] += 1
        return pmax(x, self._fork.axis_names).tolist()

    def _grant(self, turn: int, agreed: bool):
        """The waiting train step's turn: it runs on the trainer's thread
        while this thread waits."""
        with self._cond:
            step, self._step = self._step, None
        step.agreed, step.turn = agreed, turn
        step.granted.set()
        step.done.wait()
        if step.error is not None:
            raise step.error

    def _mesh_flush(self, turn: int, shape: tuple):
        """A flush turn: up to ``max_batch`` of this rank's queued
        requests, padded to ``max_batch`` rows (none: -1 rows only),
        through ``_flush_inner``; a failure raises on every rank."""
        with self._cond:
            take = [self._queue.popleft()
                    for _ in range(min(len(self._queue),
                                       self.config.max_batch))]
        try:
            self._flush_inner(take, shape)
        except BaseException as e:
            err = self._failed(f"flush turn {turn}", e)
            for p in take:
                if not p.future.done():
                    p.future.set_exception(err)
            raise err from e

    def _failed(self, what: str, exc: BaseException) -> ServingMeshError:
        """Records this rank's failure (once): the error names the rank,
        and the ranks whose failures the process group's store holds;
        this rank's own failure goes to the store for the others.

        The store is the default process group's rendezvous store, which
        torch exposes only through the private
        ``distributed_c10d._get_default_store()``: without it (another
        torch) the other ranks still raise ``ServingMeshError`` when their
        collective times out, without this rank's message."""
        import torch.distributed as dist
        rank = self._fork.rank
        mine = f"{what} failed on rank {rank}: {type(exc).__name__}: {exc}"
        get_store = getattr(dist.distributed_c10d, "_get_default_store",
                            None)
        store = get_store() if get_store is not None else None
        keys = [f"serving/{self._key}/failed/{r}"
                for r in range(self._fork.n_ranks)]
        others = []
        for r, key in enumerate(keys):
            if store is not None and r != rank and store.check([key]):
                others.append(store.get(key).decode())
        if store is not None and not isinstance(exc, ServingMeshError):
            store.set(keys[rank], mine)
        err = exc if isinstance(exc, ServingMeshError) else \
            ServingMeshError("; ".join([mine] + others))
        with self._cond:
            if self._failure is None:
                self._failure = err
            self._running = False
            self._cond.notify_all()
        return err

    def _pad_batch(self, take: list[_Pending], shape=None) -> dict:
        """The micro-batch of ``take``'s requests padded to ``max_batch``
        rows; under a mesh ``shape`` (the agreed (fields, width, dense))
        sizes it, ``take`` possibly empty."""
        B = self.config.max_batch
        if shape is None:
            r0 = take[0].request
            ids_shape = np.shape(np.asarray(r0["ids"], np.int32))
            dense_shape = np.shape(np.asarray(r0["dense"], np.float32)) \
                if "dense" in r0 else None
        else:
            ids_shape = tuple(shape[:2])
            dense_shape = (shape[2],) if shape[2] >= 0 else None
        ids = np.full((B,) + ids_shape, -1, np.int32)
        batch = {"ids": ids}
        if dense_shape is not None:
            batch["dense"] = np.zeros((B,) + dense_shape, np.float32)
        for i, p in enumerate(take):
            ids[i] = np.asarray(p.request["ids"], np.int32)
            if "dense" in batch:
                batch["dense"][i] = np.asarray(p.request["dense"],
                                               np.float32)
        return batch

    def _flush(self, take: list[_Pending]):
        """Flush one micro-batch (with no mesh; under one, a flush turn
        is ``_mesh_flush``). Never raises: a failed lookup/predict
        resolves every waiting future with the exception (a client
        blocked in ``predict`` would otherwise hang until its timeout)
        and counts ``serving/errors`` — the aggregator loop stays alive
        for the next batch."""
        try:
            self._flush_inner(take)
        except Exception as e:   # noqa: BLE001
            with self._m_lock:
                self._errors += 1
            for p in take:
                if not p.future.done():
                    p.future.set_exception(e)

    def _flush_inner(self, take: list[_Pending], shape=None):
        t_flush = time.monotonic()
        batch = self._pad_batch(take, shape)
        off = 0
        if self._fork is not None:
            batch, off = gather_row(batch)
        trainer = self.trainer
        # snapshot + read + predict all under the cell lock: the trainer
        # cannot publish mid-read, and the staleness gauge is exact (see
        # module doc)
        with self.cell.lock:
            state, snap_step = self.cell.snapshot()
            pooled, read_info = trainer.serve_lookup(state, batch)
            preds = trainer.adapter.predict(
                state.dense, pooled, batch).detach().cpu().numpy() \
                .astype(np.float32)
            lags = {n: queue_lag(state.emb_queue.get(n), snap_step,
                                 self._taus[n])
                    for n in self._tables}
            live_step = self.cell.step
        stale = {n: (live_step - snap_step) + lags[n] for n in lags}
        t_done = time.monotonic()
        for i, p in enumerate(take):
            p.future.set_result(preds[off + i])
        with self._m_lock:
            self._requests += len(take)
            self._batches += 1
            self._fill_sum += len(take) / self.config.max_batch
            for p in take:
                self._wait_ms_sum += (t_flush - p.t_submit) * 1e3
                self._lat_ms.append((t_done - p.t_submit) * 1e3)
            self._t_last = t_done
            for n, t in self._tables.items():
                inf = read_info.get(n, {})
                t["hits"] += int(inf.get("hits", 0))
                t["reads"] += int(inf.get("reads", 0))
                t["stale_last"] = int(stale[n])
                t["stale_max"] = max(t["stale_max"], int(stale[n]))

    # -- metrics -------------------------------------------------------------

    def metrics(self) -> dict:
        """Step-metrics-namespace gauges:
        ``serving/<table>/{hit_rate,stale_steps,batch_fill,wait_ms}`` plus
        the service-wide ``serving/{p50_ms,p99_ms,qps,requests,batches}``.
        ``stale_steps`` is the max observed (trainer step at write minus
        at read, plus the table's queue lag) — sync tables must read 0,
        hybrid tables at most tau."""
        with self._m_lock:
            lat = np.asarray(self._lat_ms, np.float64)
            out = {
                "serving/requests": float(self._requests),
                "serving/batches": float(self._batches),
                "serving/errors": float(self._errors),
                "serving/p50_ms": float(np.percentile(lat, 50))
                if lat.size else 0.0,
                "serving/p99_ms": float(np.percentile(lat, 99))
                if lat.size else 0.0,
            }
            span = ((self._t_last - self._t_first)
                    if (self._t_first is not None
                        and self._t_last is not None) else 0.0)
            out["serving/qps"] = (self._requests / span) if span > 0 else 0.0
            fill = (self._fill_sum / self._batches) if self._batches else 0.0
            wait = (self._wait_ms_sum / self._requests) if self._requests \
                else 0.0
            for n, t in self._tables.items():
                out[f"serving/{n}/hit_rate"] = (
                    t["hits"] / t["reads"]) if t["reads"] else 1.0
                out[f"serving/{n}/stale_steps"] = float(t["stale_max"])
                out[f"serving/{n}/batch_fill"] = fill
                out[f"serving/{n}/wait_ms"] = wait
            return out


def _request_shape(request: dict) -> tuple:
    """(fields, width, dense) of a request's ids (fields, width) and dense
    features (n,), -1 without dense features: what a flush turn pads an
    empty micro-batch to."""
    ids = np.shape(request["ids"])
    if len(ids) != 2:
        raise ValueError(f"a request's ids must be (fields, width) under a "
                         f"mesh, got shape {ids}")
    dense = int(np.size(request["dense"])) if "dense" in request else -1
    return (int(ids[0]), int(ids[1]), dense)


def gather_row(batch: dict) -> tuple[dict, int]:
    """Under the mesh in scope, the block that the ranks sharing this
    rank's batch coordinates read or train on together (a ``P(BATCH)``
    block: the ``model`` ranks of a data row): their blocks of ``batch``
    (numpy arrays, one shape on every rank) side by side along dim 0 in
    flat-index order, and the offset of this rank's rows in it. A
    collective of those ranks. With no mesh, or a mesh of one rank:
    ``(batch, 0)``."""
    import torch
    mesh = get_mesh()
    if mesh is None or mesh.n_ranks == 1:
        return batch, 0
    row =tuple(a for a in mesh.axis_names if a not in batch_axes())
    joined = {k: all_gather(torch.from_numpy(np.ascontiguousarray(v))
                            .to(mesh.device), row).cpu().numpy()
              for k, v in batch.items()}
    return joined, flat_index(row) * len(next(iter(batch.values())))
