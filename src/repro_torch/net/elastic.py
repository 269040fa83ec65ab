"""Elastic PS membership (port of ``repro/net/elastic.py``): heartbeats,
failure detection, and live recovery by resharding onto the surviving
members (paper §5 — the PS tier must tolerate shard loss without
restarting training).

Failure model (exactly the paper's): a killed shard loses its
bounded-staleness queue and any puts the trainer had not yet had ACKed —
*applied* puts were spooled to disk before their ack (see
``repro_torch.net.ps_server``), so recovery re-seeds the dead shard's rows
from its spool onto the survivors and only tolerated in-flight work is
gone. A dead member with no spool loses its rows to zero-reinit (counted
and reported, never silent).

The port's step is eager and updates the dense parameters, the optimizer
moments and the dense delay queue IN PLACE before its put goes out, so
:meth:`ElasticPSCluster.step` keeps a copy of that half (on the device)
from before every step and restarts a failed step from it. There is no
compiled program to invalidate after a membership change: the trainer
reads its backends afresh every step. A PS failure surfaces as the
transport's :class:`PSUnavailableError`, or wrapped (the pipelined
trainer's ``PipelineStageError``), so :func:`is_ps_failure` walks the
exception chain by type and by name.
"""
from __future__ import annotations

import dataclasses
import threading

import torch

from repro_torch.net import ps_server
from repro_torch.net.remote import (RemoteShardedBackend,
                                    connect_remote_backends)
from repro_torch.net.rpc import PSUnavailableError, RpcClient
from repro_torch.utils import tree_map


class ClusterDeadError(RuntimeError):
    """No recovery path left: every PS member is gone, or the retry/
    recovery budget is exhausted."""


def is_ps_failure(exc) -> bool:
    """True when ``exc`` (or anything in its cause/context chain) is — or
    wraps — a :class:`PSUnavailableError`; a wrapper that flattened it to
    text matches by name."""
    stack, seen = [exc], set()
    while stack:
        e = stack.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, PSUnavailableError):
            return True
        if "PSUnavailableError" in f"{type(e).__name__}: {e}":
            return True
        stack.extend((e.__cause__, e.__context__,
                      getattr(e, "original", None)))
    return False


@dataclasses.dataclass
class PSMember:
    """One PS process in the membership: its endpoint, where it spools
    applied state (for post-mortem recovery), and — when the launcher owns
    the process — its handle."""
    host: str
    port: int
    spool_dir: str | None = None
    proc: object = None

    @property
    def endpoint(self) -> tuple[str, int]:
        return (self.host, int(self.port))


def _as_member(m) -> PSMember:
    if isinstance(m, PSMember):
        return m
    return PSMember(*m)


def _probe(ep, timeout: float) -> bool:
    """A fresh connection and zero retries: a probe must not mask death
    behind the transport's own retry budget."""
    c = RpcClient(ep[0], ep[1], timeout=timeout, retries=0)
    try:
        return c.ping(timeout=timeout)
    finally:
        c.close()


class HeartbeatMonitor:
    """Background liveness prober: pings every member each ``interval``
    seconds and declares a member dead after ``miss_threshold``
    consecutive misses."""

    def __init__(self, endpoints, interval: float = 0.5,
                 miss_threshold: int = 2, ping_timeout: float = 0.5):
        self.interval = float(interval)
        self.miss_threshold = int(miss_threshold)
        self.ping_timeout = float(ping_timeout)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.events: list[dict] = []
        self.reset(endpoints)

    def reset(self, endpoints):
        """Adopt a new membership (post-reshard); history stays in
        ``events``, miss counters and the dead set start over."""
        with self._lock:
            self._endpoints = [tuple(e) for e in endpoints]
            self._misses = {ep: 0 for ep in self._endpoints}
            self.dead: set = set()

    def start(self) -> "HeartbeatMonitor":
        self._thread = threading.Thread(target=self._loop,
                                        name="ps-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval + 2.0)

    def _loop(self):
        while not self._stop.wait(self.interval):
            self.probe_once()

    def probe_once(self) -> set:
        """One probe round; returns the (possibly grown) dead set."""
        with self._lock:
            eps = list(self._endpoints)
        for ep in eps:
            ok = _probe(ep, self.ping_timeout)
            with self._lock:
                if ep not in self._misses:
                    continue                      # reset() raced the probe
                if ok:
                    self._misses[ep] = 0
                elif ep not in self.dead:
                    self._misses[ep] += 1
                    if self._misses[ep] >= self.miss_threshold:
                        self.dead.add(ep)
                        self.events.append({"kind": "dead", "endpoint": ep,
                                            "misses": self._misses[ep]})
        with self._lock:
            return set(self.dead)


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


class ElasticPSCluster:
    """Trainer-side membership driver: connect tables to the members,
    detect shard death (heartbeats and/or failed steps), reshard the
    survivors live, and keep stepping.

    ``step`` is the resilient entrypoint: it copies the dense half of the
    state, runs one trainer step, and on a PS failure probes the
    membership, reshards every table onto the survivors (spool blobs
    standing in for the dead), rebuilds the
    :class:`~repro_torch.core.hybrid.TrainState` from the copy and retries
    — at most ``max_recoveries`` times before :class:`ClusterDeadError`."""

    def __init__(self, trainer, members, max_recoveries: int = 2,
                 ping_timeout: float = 1.0):
        self.trainer = trainer
        self.members = [_as_member(m) for m in members]
        if not self.members:
            raise ValueError("ElasticPSCluster needs >= 1 member")
        self.max_recoveries = int(max_recoveries)
        self.ping_timeout = float(ping_timeout)
        self.events: list[dict] = []
        self.monitor: HeartbeatMonitor | None = None

    # -- membership ----------------------------------------------------------

    def endpoints(self) -> list[tuple[str, int]]:
        return [m.endpoint for m in self.members]

    def connect(self, lossy: bool | None = None, **rpc_opts) -> dict:
        connect_remote_backends(self.trainer, self.endpoints(), lossy=lossy,
                                **rpc_opts)
        for name, bk in self.trainer.backends.items():
            if not isinstance(bk, RemoteShardedBackend):
                raise TypeError(
                    f"table {name!r}: elastic membership needs sharded "
                    "remote tables — run >= 2 PS members")
        return self.trainer.backends

    def start_heartbeats(self, interval: float = 0.5,
                         miss_threshold: int = 2) -> HeartbeatMonitor:
        self.monitor = HeartbeatMonitor(
            self.endpoints(), interval=interval,
            miss_threshold=miss_threshold,
            ping_timeout=self.ping_timeout).start()
        return self.monitor

    def close(self):
        if self.monitor is not None:
            self.monitor.stop()
        for bk in self.trainer.backends.values():
            if hasattr(bk, "close"):
                bk.close()

    def probe_dead(self) -> list[int]:
        """Synchronous probe of every member; returns dead member indices
        (== shard indices: tables shard in member order)."""
        return [i for i, m in enumerate(self.members)
                if not _probe(m.endpoint, self.ping_timeout)]

    # -- state plumbing ------------------------------------------------------

    @staticmethod
    def _backup(state):
        """A copy of the non-PS half of the state (dense parameters,
        optimizer, dense delay queue, step): the step updates them in
        place."""
        return tree_map(_clone, (state.dense, state.opt, state.dense_queue,
                                 state.step))

    def _restate(self, backup, emb, emb_queue):
        from repro_torch.core.hybrid import TrainState
        dense, opt, dq, step = tree_map(_clone, backup)
        return TrainState(dense=dense, opt=opt, emb=emb,
                          emb_queue=emb_queue, dense_queue=dq, step=step)

    def _fresh_emb(self):
        """Fresh states and reset queues for the *current* shard set — the
        transient-failure rebuild (the PS state itself is intact)."""
        emb, eq = {}, {}
        for name, bk in self.trainer.backends.items():
            # outstanding window acks reference the failed step; drop them
            # so the retry doesn't re-raise a stale transport error
            bk.discard_pending()
            emb[name] = {f"s{s}": {} for s in range(bk.n_shards)}
            eq[name] = (bk._queue_init_width(bk._queue_width_cfg)
                        if bk.spec.staleness > 0 else None)
        return emb, eq

    # -- recovery ------------------------------------------------------------

    def recover(self, backup, dead: list[int]):
        """Reshard every table onto the members surviving ``dead`` (their
        spools standing in for the dead shards' rows) and rebuild the
        train state. Pending PS queues restart empty — the paper's
        tolerated in-flight loss."""
        dead = sorted(set(dead))
        survivors = [m for i, m in enumerate(self.members) if i not in dead]
        if not survivors:
            raise ClusterDeadError(
                f"all {len(self.members)} PS members are dead")
        emb, eq, lost = {}, {}, {}
        for name, bk in self.trainer.backends.items():
            # discard the table's outstanding-ack window before resharding:
            # unacked in-flight puts were addressed to the old geometry
            # (possibly the dead shard) — the paper's tolerated loss, not
            # an error to surface mid-recovery. Acked puts were spooled
            # server-side before their ack, so nothing acked is lost.
            bk.discard_pending()
            blobs = {}
            for i in dead:
                sd = self.members[i].spool_dir
                if sd is not None:
                    try:
                        blobs[i] = ps_server.read_spool(sd, name)
                    except (OSError, ValueError, KeyError):
                        blobs[i] = None             # corrupt spool == no spool
            emb[name], eq[name] = bk.reshard_live(
                [m.endpoint for m in survivors], blobs)
            lost[name] = int(bk.last_reshard_lost_rows)
        self.members = survivors
        if self.monitor is not None:
            self.monitor.reset(self.endpoints())
        self.events.append({"kind": "reshard", "dead": dead,
                            "k": len(survivors), "lost_rows": lost})
        return self._restate(backup, emb, eq)

    def join(self, member, state):
        """Grow the membership: reshard every table onto members + the
        new one (live N -> N+1) and return the rebuilt state."""
        m = _as_member(member)
        backup = self._backup(state)
        new_members = self.members + [m]
        emb, eq = {}, {}
        for name, bk in self.trainer.backends.items():
            # planned membership change, every member alive: DRAIN the
            # outstanding-ack window (don't discard) so no buffered put is
            # lost to the export — falling back to discard only if a member
            # died under us (then recover() owns the cleanup anyway)
            try:
                bk.sync(state.emb[name])
            except Exception:                          # noqa: BLE001
                bk.discard_pending()
            emb[name], eq[name] = bk.reshard_live(
                [mm.endpoint for mm in new_members], None)
        self.members = new_members
        if self.monitor is not None:
            self.monitor.reset(self.endpoints())
        self.events.append({"kind": "join", "endpoint": m.endpoint,
                            "k": len(new_members)})
        return self._restate(backup, emb, eq)

    # -- the resilient step loop ---------------------------------------------

    def step(self, state, batch, step_fn=None):
        """One trainer step that survives shard death. ``step_fn`` defaults
        to the trainer's ``decomposed_step``; anything with the
        ``(state, batch) -> (state, metrics)`` shape works."""
        fn = step_fn if step_fn is not None else self.trainer.decomposed_step
        last: Exception | None = None
        for attempt in range(self.max_recoveries + 1):
            backup = self._backup(state)
            try:
                return fn(state, batch)
            except Exception as e:                     # noqa: BLE001
                if not is_ps_failure(e):
                    raise
                last = e
                if attempt == self.max_recoveries:
                    break
                dead = self.probe_dead()
                if dead:
                    state = self.recover(backup, dead)
                else:
                    # transient (timeout blip): the membership is intact,
                    # rebuild the table states and retry the step
                    self.events.append({"kind": "transient"})
                    emb, eq = self._fresh_emb()
                    state = self._restate(backup, emb, eq)
        raise ClusterDeadError(
            f"PS failure persisted through {self.max_recoveries} "
            f"recoveries") from last
