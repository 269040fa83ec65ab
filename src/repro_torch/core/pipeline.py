"""Pipelined execution of the hybrid trainer (port of ``repro/core/
pipeline.py``, paper §4, Fig. 4–5).

:class:`~repro_torch.core.hybrid.PersiaTrainer` runs ``prepare → lookup →
dense → put`` strictly serially per batch; this module runs the same
stages (plus the data loader and an optional prefetch stage) as a bounded
pipeline, one host thread per stage:

    loader ──q──▶ prefetch ──q──▶ prepare ──q──▶ lookup ──q──▶ dense ──q──▶ put
    (batches)    (look-ahead     (host plans,    (one bag     (FFNN fwd/  (fused_
                  fault-in)       fault-in)       launch)      bwd, Adam)  backward)

so the host work of step t+1 (plans, fault-in, dispatch) overlaps step t's.
With ``prefetch=k > 0`` the fault-in moves into the prefetch stage, which
may run up to ``k`` batches ahead of the inflight window; ``prefetch=0``
keeps it in the prepare stage, and the prefetch stage passes batches on.

The guarantees are the JAX package's:

* **Bounded staleness, by backpressure.** Per (table, PS shard), the puts
  outstanding (batches past their lookup whose put has not been applied)
  never exceed ``min(max_inflight, tau)``, and 1 for synchronous tables:
  a counting semaphore blocks the lookup stage instead of dropping puts.
  A lookup may read parameters up to ``tau + min(max_inflight, tau)``
  updates old; set ``max_inflight=1`` where the serial staleness matters.
* **Sequenced table state.** Every dispatch that touches the tables, the
  accumulators, the staleness queues or a host_lru table's slot map runs
  under one store lock: a host_lru prepare's eviction and fault-in, the
  lookup and the put, so the puts apply in batch order. The dense
  parameters and optimizer belong to the dense stage alone. Host-backed
  tables pin each in-flight batch's cache slots from its prepare to its
  applied put, so a deeper fault-in can never recycle a row that a pending
  lookup or put still targets; a fault-in that cannot fit raises.
* **Fail fast.** A stage that raises stops the pipeline, and ``run``
  re-raises it as :class:`PipelineStageError` naming the stage and step;
  the queue and semaphore waits poll a stop event, so nothing hangs.

With ``max_inflight=1`` the permit cycle (prepare acquires, put releases)
reproduces the serial order of ``decomposed_step`` exactly, so the result
equals the serial trainer's bit for bit, on the card as on the CPU.

What differs from the JAX package, all of eager PyTorch on one card:

* JAX orders its stages through functional arrays: the lookup reads a
  snapshot and the put donates. The port updates its tables in place, so
  it relies on dispatch order instead: every stage thread enters the
  trainer's device and dispatches on that device's one current stream
  (the default stream), in the order the locks give, so dispatch order
  is execution order, as with XLA's asynchronous dispatch. No side stream
  is used: the election scratch of ``fused_backward``
  (``ops._election_scratch``), which every table of a size shares, stays
  on that one stream, and only the put stage launches that kernel.
* The store lock is narrower than JAX's for the prepare: the plans
  (``np.unique``, the occurrence CSR, the shuffle) and the upload touch
  no table state and run outside it; only the prepare phase that does (a
  host_lru table's slot map, eviction and fault-in, and the pins) holds it
  (``backend.prepare_all``'s ``lock``). The lookup and the put hold it
  whole, as in the JAX package.
* Pins are taken from the host arrays that ``prepare_all`` built and
  uploaded (``pins``), so pinning and unpinning wait for no device.
* A host_lru prepare that evicts still copies the victims' rows to the
  host and waits for the stream (``stage_s["evict_sync"]``): on the one
  stream that wait also covers another batch's dense step in flight. It is
  correct (the gather follows every put dispatched before it, and the
  fault-in's writes follow the gather), and it is reported per step.
* The stage threads share the interpreter lock: numpy's sorts, PyTorch's
  op dispatch, the ctypes kernel launches and ``time.sleep`` release it,
  but the Python between them does not, so the stages overlap only as far
  as their host work is outside the lock.
* Under a mesh (``utils.set_mesh``), the fault-in (prepare or prefetch),
  lookup, dense and put stages run collectives: a host_lru fault-in
  gathers the batch's ids and its evicted rows, a remote table's takes
  the first rank's result. Each stage thread runs them over process
  groups of its own (a :meth:`~repro_torch.utils.Mesh.fork` of the mesh,
  made once per engine and mesh, in the same order on every rank), so no
  two threads' calls interleave on one group. The store lock orders a
  rank's fault-ins, lookups and puts, and ranks must order them alike:
  else a rank's put waits in a collective for a peer whose fault-in waits
  for that rank's, behind the put, and a rank's eviction writes back
  rows that its peers' puts have or have not reached yet, so the
  replicated caches and host stores part. So every rank runs them in
  one order (``_Turns``): F0 .. F(h-1) L0 .. L(w-1), then P(i) F(i + h)
  L(i + w) for each i (h: max_inflight + prefetch, the fault-in's
  horizon; w: the smallest put window). With max_inflight=1 that is the
  serial order.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, Callable, Iterable, Optional

import torch

from repro_torch.core import backend as BK
from repro_torch.core.hybrid import PersiaTrainer, TrainState
from repro_torch.utils import get_mesh, use_groups

STAGES = ("loader", "prefetch", "prepare", "lookup", "dense", "put")

_DONE = object()          # end-of-stream sentinel flowing through the queues
_TICK = 0.02              # poll period for stop-aware queue/semaphore waits


class PipelineStageError(RuntimeError):
    """A pipeline stage raised; carries the stage name, step and cause."""

    def __init__(self, stage: str, step: int, original: BaseException):
        super().__init__(
            f"pipeline stage {stage!r} failed at step {step}: "
            f"{type(original).__name__}: {original}")
        self.stage = stage
        self.step = step
        self.original = original


class _StageStats:
    """Per-stage busy time + items + input-queue depth accounting."""

    def __init__(self):
        self.busy_s = 0.0
        self.items = 0
        self.depth_max = 0
        self.depth_sum = 0
        self.depth_samples = 0

    def sample_depth(self, depth: int):
        self.depth_max = max(self.depth_max, depth)
        self.depth_sum += depth
        self.depth_samples += 1


class _Turns:
    """The one order in which every rank of a mesh runs its fault-ins (F),
    lookups (L) and puts (P) (see the module note): F0 .. F(h-1), L0 ..
    L(w-1), then P(i), F(i + h), L(i + w) for i = 0, 1, ..., where ``h``
    is the fault-in horizon (max_inflight + prefetch) and ``w`` the
    smallest put window; a batch past the end of the stream (``end``)
    is skipped. Each event comes after what it waits for: F(j) after P(j -
    h) (the inflight or prefetch permit), L(j) after F(j) and P(j - w)
    (the windows), P(i) after L(i + w - 1) (so lookups and puts keep the
    order L0 .. L(w-1) P0 Lw P1 ...)."""

    def __init__(self, h: int, w: int, stop: threading.Event):
        self._order = self._events(h, w)
        self._ran = {"F": 0, "L": 0, "P": 0}
        self._end = {"F": None, "L": None}
        self._stop = stop
        self._cv = threading.Condition()
        self._cur = next(self._order)

    @staticmethod
    def _events(h: int, w: int):
        yield from (("F", j) for j in range(h))
        yield from (("L", j) for j in range(w))
        i = 0
        while True:
            yield from (("P", i), ("F", i + h), ("L", i + w))
            i += 1

    def _skip(self):
        while True:
            kind, idx = self._cur
            # a put exists for every lookup that ran
            end = self._end["L" if kind == "P" else kind]
            if end is None or idx < end:
                return
            self._cur = next(self._order)

    def wait(self, kind: str, idx: int) -> bool:
        """Block until it is ``(kind, idx)``'s turn; False on a stop."""
        with self._cv:
            while not self._stop.is_set():
                self._skip()
                if self._cur == (kind, idx):
                    return True
                self._cv.wait(timeout=_TICK)
        return False

    def advance(self):
        """The event whose turn it was has run."""
        with self._cv:
            self._ran[self._cur[0]] += 1
            self._cur = next(self._order)
            self._cv.notify_all()

    def end(self, kind: str):
        """The stream ended: no ``kind`` event past those that ran."""
        with self._cv:
            self._end[kind] = self._ran[kind]
            self._cv.notify_all()


class PipelinedTrainer:
    """Bounded multi-stage pipeline over ``PersiaTrainer.decomposed_fns()``.

    >>> trainer = PersiaTrainer(adapter, TrainMode.hybrid(3), opt)
    >>> engine = PipelinedTrainer(trainer, max_inflight=4)
    >>> state = engine.init(seed=0, batch_example=batch)      # delegated
    >>> state, metrics = engine.run(state, batches)           # pipelined
    >>> engine.pipeline_metrics()["pipeline/prepare/busy_s"]
    >>> engine.eval(state, batch); engine.save(d, state)      # delegated

    ``init`` / ``eval`` / ``save`` / ``restore`` (and ``step`` /
    ``decomposed_step`` / ``lookup`` / ``predict``) delegate to the wrapped
    trainer, so the engine stands in for the serial facade wherever the
    stream-level ``run`` replaces the per-batch step. ``run()`` owns the
    train state while it executes: do not eval or save concurrently.
    """

    def __init__(self, trainer: PersiaTrainer, max_inflight: int = 4,
                 delay_fn: Optional[Callable[[str, int], float]] = None,
                 prefetch: int = 0):
        if not isinstance(trainer, PersiaTrainer):
            raise TypeError(
                "PipelinedTrainer wraps a PersiaTrainer (build one first); "
                f"got {type(trainer).__name__}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1 "
                             f"(got {max_inflight})")
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0 (got {prefetch})")
        self.trainer = trainer
        self.max_inflight = int(max_inflight)
        # prefetch > 0 moves the fault-in (prepare_all + slot pinning) into
        # a stage that may run up to ``prefetch`` batches AHEAD of the
        # inflight window; its slots stay pinned until the batch's applied
        # put, so ``cache_rows`` must cover the combined (max_inflight +
        # prefetch) working set or the fault-in raises
        self.prefetch = int(prefetch)
        self.delay_fn = delay_fn
        self._stats: dict[str, _StageStats] = {}
        self._wall_s = 0.0
        self._steps_done = 0
        self.max_outstanding: dict[str, int] = {}
        self.applied_order: list[int] = []
        self._running = False
        self._forks: tuple = (None, {})     # (mesh, {stage: its fork})

    # -- delegated PersiaTrainer surface --------------------------------------

    @property
    def adapter(self):
        return self.trainer.adapter

    @property
    def mode(self):
        return self.trainer.mode

    @property
    def collection(self):
        return self.trainer.collection

    @property
    def backends(self):
        return self.trainer.backends

    @property
    def device(self) -> torch.device:
        return self.trainer.device

    def init(self, seed: int = 0, batch_example=None,
             emb_shards=1) -> TrainState:
        return self.trainer.init(seed, batch_example, emb_shards)

    def step(self, state, batch):
        return self.trainer.step(state, batch)

    def decomposed_step(self, state, batch):
        return self.trainer.decomposed_step(state, batch)

    def eval(self, state, batch):
        return self.trainer.eval(state, batch)

    def lookup(self, state, batch):
        return self.trainer.lookup(state, batch)

    def predict(self, state, batch):
        return self.trainer.predict(state, batch)

    def save(self, directory: str, state: TrainState,
             step: int | None = None) -> str:
        return self.trainer.save(directory, state, step)

    def restore(self, directory: str, step: int | None = None) -> TrainState:
        return self.trainer.restore(directory, step)

    # -- the staleness window -------------------------------------------------

    def put_window(self, name: str) -> int:
        """Max puts outstanding (post-lookup, pre-apply) for one table: the
        pipeline may run at most ``tau`` lookups ahead of the last applied
        put (1 for synchronous tables: sync means no un-applied put is
        ever read past), and never more than ``max_inflight``."""
        tau = self.trainer.collection[name].staleness
        return 1 if tau <= 0 else min(self.max_inflight, tau)

    def _stage_groups(self) -> dict:
        """{stage: a fork of the mesh in scope} for the stages that run
        collectives, made once per engine and mesh (collective: every rank
        builds them at its first run under the mesh); empty without a
        mesh of more than one rank."""
        mesh = get_mesh()
        if mesh is None or mesh.n_ranks == 1:
            return {}
        if self._forks[0] is not mesh:
            self._forks = (mesh, {s: mesh.fork() for s in
                                  ("prefetch", "prepare", "lookup", "dense",
                                   "put")})
        return self._forks[1]

    # -- the pipelined loop ---------------------------------------------------

    def run(self, state: TrainState, batches: Iterable[Any],
            steps: int | None = None,
            delay_fn: Optional[Callable[[str, int], float]] = None
            ) -> tuple[TrainState, list[dict]]:
        """Drive ``batches`` (an iterable of batch dicts, optionally capped
        at ``steps``) through the stages; returns the final state and the
        per-step metrics in batch order. The tables and queues of ``state``
        are updated in place: use only the returned state afterwards."""
        if self._running:
            raise RuntimeError("run() is not reentrant: this engine is "
                               "already driving a pipeline")
        delay_fn = delay_fn if delay_fn is not None else self.delay_fn
        trainer = self.trainer
        lookup_fn, dense_step, emb_put = trainer.decomposed_fns()
        adapter, backends = trainer.adapter, trainer.backends
        names = trainer.collection.names
        device = trainer.device

        # shared cells: the table store (tables, accumulators, staleness
        # queues, host_lru slot maps; every dispatch that touches them is
        # serialized by store_lock) and the dense cell (the dense stage's
        # alone, no lock needed)
        store = {"emb": state.emb, "queues": state.emb_queue}
        store_lock = threading.Lock()
        dense_cell = {"dense": state.dense, "opt": state.opt,
                      "queue": state.dense_queue, "step": state.step}

        stop = threading.Event()
        errors: list[PipelineStageError] = []
        inflight = threading.Semaphore(self.max_inflight)
        # put backpressure per (table, PS shard): a router table has one
        # window per shard, an unsharded table is its one shard 0
        windows = {(n, s): threading.Semaphore(self.put_window(n))
                   for n in names
                   for s in range(backends[n].n_put_shards())}
        out_lock = threading.Lock()
        outstanding = {n: 0 for n in names}
        self.max_outstanding = {n: 0 for n in names}
        self.applied_order = []
        # the prefetch horizon: batches between prefetch-start and
        # put-applied (the inflight window plus the look-ahead depth)
        prefetch_sem = threading.Semaphore(self.max_inflight + self.prefetch)
        self._stats = {s: _StageStats() for s in STAGES}
        qs = {s: queue.Queue(maxsize=self.max_inflight)
              for s in ("prefetch", "lookup", "dense", "put")}
        # the prepare queue buffers the look-ahead: faulted batches wait
        # here until the inflight window admits them
        qs["prepare"] = queue.Queue(
            maxsize=self.max_inflight + self.prefetch)
        results: list[tuple[int, dict]] = []
        groups = self._stage_groups()
        # under a mesh every rank runs the fault-ins, lookups and puts in
        # one order (see the module note)
        w_min = min((self.put_window(n) for n in names), default=1)
        turns = _Turns(self.max_inflight + self.prefetch, w_min, stop) \
            if groups else None

        @contextlib.contextmanager
        def turn(kind: str, idx: int):
            if turns is None:
                yield True
                return
            ok = turns.wait(kind, idx)
            try:
                yield ok
            finally:
                if ok:
                    turns.advance()

        def fail(stage: str, idx: int, exc: BaseException):
            errors.append(PipelineStageError(stage, idx, exc))
            stop.set()

        def sleep_for(stage: str, idx: int):
            if delay_fn is not None:
                d = float(delay_fn(stage, idx))
                if d > 0:
                    time.sleep(d)

        def q_put(stage_to: str, item) -> bool:
            q = qs[stage_to]
            while not stop.is_set():
                try:
                    q.put(item, timeout=_TICK)
                    self._stats[stage_to].sample_depth(q.qsize())
                    return True
                except queue.Full:
                    pass
            return False

        def q_get(stage: str):
            q = qs[stage]
            while not stop.is_set():
                try:
                    return q.get(timeout=_TICK)
                except queue.Empty:
                    pass
            return None

        def acquire(sem: threading.Semaphore) -> bool:
            while not stop.is_set():
                if sem.acquire(timeout=_TICK):
                    return True
            return False

        def loader():
            st = self._stats["loader"]
            idx = 0
            try:
                for batch in batches:
                    if steps is not None and idx >= steps:
                        break
                    if stop.is_set():
                        return
                    t0 = time.perf_counter()
                    sleep_for("loader", idx)
                    st.busy_s += time.perf_counter() - t0
                    st.items += 1
                    if not q_put("prefetch", (idx, batch)):
                        return
                    idx += 1
                q_put("prefetch", _DONE)
            except Exception as e:   # noqa: BLE001
                fail("loader", idx, e)

        def touched_shards(n, pins):
            """(table, shard) windows this batch must charge: every shard
            of a hybrid sharded table, the routed shards of a sync one,
            shard 0 of an unsharded table."""
            bk = backends[n]
            if bk.n_put_shards() > 1 and \
                    trainer.collection[n].staleness > 0:
                return tuple(range(bk.n_put_shards()))
            return bk.put_shards(pins[n]) if n in pins else (0,)

        def fault_in(idx, batch):
            """The host prepare: every table's plan, then (under the store
            lock) its fault-in and the pin of its slots until its put has
            been applied, then the upload. The pins are the host arrays
            the upload was made from; the touched shards are decoded from
            them too. ``None`` when the run stops before its turn."""
            ids = adapter.emb_ids(batch)
            pins: dict = {}
            with turn("F", idx) as ok:
                if not ok:
                    return None
                emb, dev_ids, prep_m = BK.prepare_all(
                    backends, store["emb"], ids, device, lock=store_lock,
                    pins=pins)
            with store_lock:
                store["emb"] = emb
            touched = {n: touched_shards(n, pins) for n in names}
            return dev_ids, pins, touched, prep_m

        def prefetch_stage():
            # prefetch=0: a passthrough (no permits, no timing), the
            # fault-in stays in prepare and the dispatch order is unchanged
            st = self._stats["prefetch"]
            while True:
                item = q_get("prefetch")
                if item is None:
                    return
                if item is _DONE:
                    if self.prefetch > 0 and turns is not None:
                        turns.end("F")
                    q_put("prepare", _DONE)
                    return
                if self.prefetch <= 0:
                    if not q_put("prepare", item):
                        return
                    st.items += 1
                    continue
                idx, batch = item
                try:
                    if not acquire(prefetch_sem):
                        return
                    t0 = time.perf_counter()
                    sleep_for("prefetch", idx)
                    faulted = fault_in(idx, batch)
                    if faulted is None:
                        return
                    st.busy_s += time.perf_counter() - t0
                    st.items += 1
                    if not q_put("prepare", (idx, batch, *faulted)):
                        return
                except Exception as e:   # noqa: BLE001
                    fail("prefetch", idx, e)
                    return

        def prepare():
            st = self._stats["prepare"]
            while True:
                item = q_get("prepare")
                if item is None:
                    return
                if item is _DONE:
                    if self.prefetch <= 0 and turns is not None:
                        turns.end("F")
                    q_put("lookup", _DONE)
                    return
                idx, batch = item[0], item[1]
                try:
                    # the global permit: at most max_inflight batches
                    # between prepare-start and put-applied. With one
                    # permit this pins the exact serial dispatch order.
                    if not acquire(inflight):
                        return
                    t0 = time.perf_counter()
                    sleep_for("prepare", idx)
                    faulted = fault_in(idx, batch) if len(item) == 2 \
                        else item[2:]        # faulted by the prefetch stage
                    if faulted is None:
                        return
                    st.busy_s += time.perf_counter() - t0
                    st.items += 1
                    if not q_put("lookup", (idx, batch, *faulted)):
                        return
                except Exception as e:   # noqa: BLE001
                    fail("prepare", idx, e)
                    return

        def lookup_stage():
            st = self._stats["lookup"]
            while True:
                item = q_get("lookup")
                if item is None:
                    return
                if item is _DONE:
                    if turns is not None:
                        turns.end("L")
                    q_put("dense", _DONE)
                    return
                idx, batch, dev_ids, pins, touched, prep_m = item
                try:
                    t0 = time.perf_counter()
                    sleep_for("lookup", idx)
                    # staleness backpressure: block (never drop) until every
                    # (table, shard) this batch charges is within its window
                    for n in names:
                        for s in touched[n]:
                            if not acquire(windows[(n, s)]):
                                return
                    with out_lock:
                        for n in names:
                            outstanding[n] += 1
                            self.max_outstanding[n] = max(
                                self.max_outstanding[n], outstanding[n])
                    with turn("L", idx) as ok:
                        if not ok:
                            return
                        with store_lock:
                            pooled, get_m = lookup_fn(store["emb"], dev_ids)
                    st.busy_s += time.perf_counter() - t0
                    st.items += 1
                    if not q_put("dense", (idx, batch, dev_ids, pins, pooled,
                                           get_m, touched, prep_m)):
                        return
                except Exception as e:   # noqa: BLE001
                    fail("lookup", idx, e)
                    return

        def dense_stage():
            st = self._stats["dense"]
            while True:
                item = q_get("dense")
                if item is None:
                    return
                if item is _DONE:
                    q_put("put", _DONE)
                    return
                idx, batch, dev_ids, pins, pooled, get_m, touched, prep_m \
                    = item
                try:
                    t0 = time.perf_counter()
                    sleep_for("dense", idx)
                    d = dense_cell
                    dense, opt, dq, agrads, metrics = dense_step(
                        d["dense"], d["opt"], d["queue"], pooled, batch,
                        d["step"])
                    dense_cell.update(dense=dense, opt=opt, queue=dq,
                                      step=d["step"] + 1)
                    st.busy_s += time.perf_counter() - t0
                    st.items += 1
                    if not q_put("put", (idx, dev_ids, pins, agrads, metrics,
                                         get_m, touched, prep_m)):
                        return
                except Exception as e:   # noqa: BLE001
                    fail("dense", idx, e)
                    return

        def put_stage():
            st = self._stats["put"]
            while True:
                item = q_get("put")
                if item is None or item is _DONE:
                    return
                idx, dev_ids, pins, agrads, metrics, get_m, touched, prep_m \
                    = item
                try:
                    t0 = time.perf_counter()
                    sleep_for("put", idx)
                    with turn("P", idx) as ok:
                        if not ok:
                            return
                        with store_lock:
                            emb, queues, put_m = emb_put(
                                store["emb"], store["queues"], dev_ids,
                                agrads)
                            store["emb"] = emb
                            store["queues"] = queues
                            for n, slots in pins.items():
                                backends[n].unpin_slots(slots)
                    self.applied_order.append(idx)
                    with out_lock:
                        for n in names:
                            outstanding[n] -= 1
                    for n in names:
                        for s in touched[n]:
                            windows[(n, s)].release()
                    inflight.release()
                    if self.prefetch > 0:
                        prefetch_sem.release()
                    merged = dict(metrics)
                    merged.update(prep_m)
                    merged.update(get_m)
                    merged.update(put_m)
                    merged.update(BK.shard_step_metrics(backends))
                    results.append((idx, merged))
                    st.busy_s += time.perf_counter() - t0
                    st.items += 1
                except Exception as e:   # noqa: BLE001
                    fail("put", idx, e)
                    return

        def on_device(name, fn):
            """A stage body that dispatches on the trainer's device (the
            current CUDA device is per host thread, and a new thread
            starts on device 0) and, under a mesh, runs its collectives
            over its own groups."""
            def body():
                with torch.cuda.device(device) if device.type == "cuda" \
                        else contextlib.nullcontext(), \
                        use_groups(groups.get(name)):
                    fn()
            return body

        threads = [
            threading.Thread(target=on_device(name, fn),
                             name=f"pipeline-{name}",
                             daemon=True)
            for name, fn in (("loader", loader),
                             ("prefetch", prefetch_stage),
                             ("prepare", prepare),
                             ("lookup", lookup_stage), ("dense", dense_stage),
                             ("put", put_stage))]
        self._running = True
        t_wall = time.perf_counter()
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600.0)
            hung = [t.name for t in threads if t.is_alive()]
            if hung and not errors:
                stop.set()
                raise PipelineStageError(
                    hung[0].removeprefix("pipeline-"), -1,
                    TimeoutError("stage did not finish within 600s"))
        finally:
            stop.set()
            # an aborted run may leave batches pinned mid-flight; the
            # backends outlive the run, so drop the pins before handing
            # the trainer back
            for b in backends.values():
                b.reset_pins()
            self._wall_s = time.perf_counter() - t_wall
            self._steps_done = len(results)
            self._running = False
        if errors:
            raise errors[0]

        results.sort(key=lambda r: r[0])
        final = state.replace(
            dense=dense_cell["dense"], opt=dense_cell["opt"],
            dense_queue=dense_cell["queue"], step=dense_cell["step"],
            emb=store["emb"], emb_queue=store["queues"])
        return final, [m for _, m in results]

    # -- per-stage metrics ----------------------------------------------------

    def pipeline_metrics(self) -> dict[str, float]:
        """Timing and occupancy of the last ``run()``: per-stage busy
        seconds, occupancy (busy / wall), items, and input-queue depth
        stats, plus the run-level wall time and steps/s (host clock; on
        the card the run's last put may still be executing when it ends)."""
        wall = max(self._wall_s, 1e-9)
        out: dict[str, float] = {
            "pipeline/wall_s": self._wall_s,
            "pipeline/steps": float(self._steps_done),
            "pipeline/steps_per_s": self._steps_done / wall,
            "pipeline/max_inflight": float(self.max_inflight),
            "pipeline/prefetch": float(self.prefetch),
        }
        for stage, st in self._stats.items():
            out[f"pipeline/{stage}/busy_s"] = st.busy_s
            out[f"pipeline/{stage}/occupancy"] = st.busy_s / wall
            out[f"pipeline/{stage}/items"] = float(st.items)
            if stage != "loader":        # stages fed by a bounded queue
                avg = (st.depth_sum / st.depth_samples
                       if st.depth_samples else 0.0)
                out[f"pipeline/{stage}/queue_depth"] = avg
                out[f"pipeline/{stage}/queue_depth_max"] = float(st.depth_max)
        for n, v in self.max_outstanding.items():
            out[f"pipeline/outstanding_puts_max/{n}"] = float(v)
        return out
