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
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np


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

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-flush", daemon=True)
        self._thread.start()
        return self

    def stop(self):
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
            if not self._running:
                raise RuntimeError("service not running")
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

    def _pad_batch(self, take: list[_Pending]) -> dict:
        B = self.config.max_batch
        r0 = take[0].request
        ids0 = np.asarray(r0["ids"], np.int32)
        ids = np.full((B,) + ids0.shape, -1, np.int32)
        batch = {"ids": ids}
        if "dense" in r0:
            batch["dense"] = np.zeros(
                (B,) + np.shape(np.asarray(r0["dense"], np.float32)),
                np.float32)
        for i, p in enumerate(take):
            ids[i] = np.asarray(p.request["ids"], np.int32)
            if "dense" in batch:
                batch["dense"][i] = np.asarray(p.request["dense"],
                                               np.float32)
        return batch

    def _flush(self, take: list[_Pending]):
        """Flush one micro-batch. Never raises: a failed lookup/predict
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

    def _flush_inner(self, take: list[_Pending]):
        t_flush = time.monotonic()
        batch = self._pad_batch(take)
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
            p.future.set_result(preds[i])
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
