"""Pipelined request/response RPC over rid-tagged
:mod:`repro_torch.net.wire` frames (copy of ``repro/net/rpc.py``; the
standard library only, so either package's client calls the other's
server).

Design points (all load-bearing for the PS tier):

* One persistent TCP connection per client, **many requests in flight**:
  every frame carries a transport ``rid``; a per-client io thread demuxes
  replies into the futures ``call_async`` returned. Latency overlaps —
  a window of puts costs ~one RTT, not window RTTs.
* The server executes every op on a connection **serially, in arrival
  order** (ops listed in ``concurrent_ops`` — liveness probes — may
  overtake via a small pool). Client-side send order is the apply order,
  which is what lets the remote backend pipeline puts without draining
  before each prepare.
* Per-request timeout + bounded retry with exponential backoff. A dead
  connection is recovered by the io thread: it reconnects and **resends
  every pending request in rid order**; requests that exhaust their
  budget fail with :class:`PSUnavailableError` — the *named* error the
  elastic layer catches to trigger a membership change.
* Mutating ops carry a ``(client, seq)`` pair; the server keeps a
  **window** of recently applied seqs per client (not just the last one —
  several may be in flight) and replays the cached reply instead of
  re-applying, so a resend after a lost reply cannot double-apply a
  gradient put (exactly-once apply over an at-least-once transport).
* **Op coalescing**: ``coalesce()`` buffers sub-ops client-side and
  ``flush()`` ships them as one ``step_ops`` frame the server unpacks and
  runs in order (one seq — the batch replays as a unit). Any direct call
  flushes the buffer first, so coalescing never reorders against
  non-coalesced traffic.
* A handler exception travels back as :class:`RpcError` with the remote
  type name — the server stays up (bad request != dead shard).
* ``reply_delay`` on the server delays every reply send by a fixed
  interval through a writer thread: the injected-RTT harness the
  benchmarks use to measure pipelining (a blocking client pays the delay
  per op; the pipelined client pays it once per overlapped window).
"""
from __future__ import annotations

import heapq
import select
import socket
import threading
import time
import traceback
import uuid
from collections import OrderedDict
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutTimeoutError

from repro_torch.net import wire

# ops safe to answer out of order (liveness/introspection only — never
# table state); everything else on a connection runs serially in arrival
# order, which is the ordering contract pipelined puts rely on
CONCURRENT_OPS = frozenset({"ping"})

REPLAY_WINDOW = 1024          # cached replies per client (>= max in-flight)
COALESCE_MAX_OPS = 64         # auto-flush bounds for the step_ops buffer
COALESCE_MAX_BYTES = 8 << 20


class RpcError(RuntimeError):
    """The remote handler raised; carries the remote type and message."""


class PSUnavailableError(ConnectionError):
    """A PS endpoint could not be reached within the retry budget."""


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class _ReplyWriter:
    """Per-connection writer thread that sends each reply ``delay``
    seconds after it was produced — the injected-RTT harness. Only exists
    when ``reply_delay > 0``; the zero-delay path sends inline."""

    def __init__(self, conn: socket.socket, delay: float):
        self.conn, self.delay = conn, float(delay)
        self._heap: list = []
        self._n = 0
        self._cond = threading.Condition()
        self._stopping = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rpc-reply-writer")
        self._thread.start()

    def send(self, rid: int, parts: list):
        with self._cond:
            self._n += 1
            heapq.heappush(self._heap,
                           (time.monotonic() + self.delay, self._n, rid,
                            parts))
            self._cond.notify()

    def _run(self):
        while True:
            with self._cond:
                while not self._stopping and not self._heap:
                    self._cond.wait()
                if self._stopping:
                    return
                due = self._heap[0][0]
                now = time.monotonic()
                if now < due:
                    self._cond.wait(timeout=due - now)
                    continue
                _, _, rid, parts = heapq.heappop(self._heap)
            try:
                wire.send_frame_parts(self.conn, rid, parts)
            except (OSError, wire.WireError):
                return

    def stop(self):
        with self._cond:
            self._stopping = True
            self._cond.notify()
        self._thread.join(timeout=5.0)


class RpcServer:
    """Frame server dispatching ``op`` to handlers, one thread per
    connection, ops executed serially in arrival order per connection.

    ``handlers`` maps op name -> callable(**args) returning an encodable
    tree. Requests carrying a ``(client, seq)`` pair (the client attaches
    them to mutating ops) get replay suppression over a window of
    :data:`REPLAY_WINDOW` recent seqs. ``concurrent_ops`` may complete
    out of order (dispatched to a pool). ``reply_delay`` delays every
    reply send by that many seconds (injected RTT for benchmarks).
    """

    def __init__(self, handlers: dict, host: str = "127.0.0.1",
                 port: int = 0, mutating_ops: set | None = None,
                 concurrent_ops: set | None = None,
                 reply_delay: float = 0.0):
        self.handlers = dict(handlers)
        self.mutating_ops = set(mutating_ops or ())
        self.concurrent_ops = set(CONCURRENT_OPS if concurrent_ops is None
                                  else concurrent_ops)
        self.reply_delay = float(reply_delay)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()[:2]
        self._threads: list[threading.Thread] = []
        self._conns: set = set()
        self._conn_lock = threading.Lock()
        self._replay_lock = threading.Lock()
        self._applied: dict[str, OrderedDict] = {}
        self._pool: ThreadPoolExecutor | None = None
        self._stopping = False
        self._accept_thread: threading.Thread | None = None
        self.frames_recv = 0

    def start(self) -> "RpcServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"rpc-accept-{self.port}",
            daemon=True)
        self._accept_thread.start()
        return self

    def stop(self):
        self._stopping = True
        try:
            # closing alone leaves a thread blocked in accept() holding the
            # kernel socket in LISTEN; shutdown wakes it so the port frees
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        # join the per-connection handler threads too — closing the sockets
        # above unblocks their recv, so repeated start/stop in tests cannot
        # accumulate live threads holding ports/fds
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = [t for t in self._threads if t.is_alive()]
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix=f"rpc-conc-{self.port}")
        return self._pool

    def _accept_loop(self):
        while not self._stopping:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conn_lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name=f"rpc-conn-{self.port}", daemon=True)
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket):
        writer = (_ReplyWriter(conn, self.reply_delay)
                  if self.reply_delay > 0 else None)
        send_lock = threading.Lock()

        def reply(rid: int, parts: list):
            try:
                if writer is not None:
                    writer.send(rid, parts)
                else:
                    with send_lock:
                        wire.send_frame_parts(conn, rid, parts)
            except (OSError, wire.WireError):
                pass

        rbuf = wire.RecvBuffer()
        try:
            while not self._stopping:
                try:
                    rid, view = wire.recv_frame_tagged(conn, rbuf)
                except (wire.WireError, OSError):
                    return
                self.frames_recv += 1
                try:
                    msg = wire.decode(view)
                except Exception:                        # noqa: BLE001
                    return          # undecodable request: drop the conn
                if msg.get("op") in self.concurrent_ops:
                    self._ensure_pool().submit(
                        lambda m=msg, r=rid: reply(r, self._dispatch(m)))
                else:
                    reply(rid, self._dispatch(msg))
        finally:
            if writer is not None:
                writer.stop()
            with self._conn_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _run_handler(self, op: str, args: dict):
        handler = self.handlers.get(op)
        if handler is None:
            raise KeyError(f"unknown rpc op {op!r}")
        return handler(**args)

    def _dispatch(self, msg: dict) -> list:
        """Decoded request -> encoded reply parts. Replay suppression keys
        on the request's ``(client, seq)``: a window of recent seqs per
        client, because a pipelined client may retry any of its in-flight
        seqs (not only the latest) after a lost reply."""
        try:
            op = msg["op"]
            args = msg.get("args") or {}
            seq, client = msg.get("seq"), msg.get("client")
            replay = seq is not None and client is not None
            if replay:
                with self._replay_lock:
                    cache = self._applied.setdefault(client, OrderedDict())
                    cached = cache.get(seq)
                if cached is not None:
                    return cached
            if op == "step_ops":
                result = [self._run_sub(sub) for sub in args["ops"]]
            else:
                result = self._run_handler(op, args)
            parts = wire.encode_parts({"ok": result})
            if replay:
                with self._replay_lock:
                    cache[seq] = parts
                    while len(cache) > REPLAY_WINDOW:
                        cache.popitem(last=False)
            return parts
        except Exception as e:                         # noqa: BLE001
            return wire.encode_parts({
                "err": f"{type(e).__name__}: {e}",
                "tb": traceback.format_exc(limit=8),
            })

    def _run_sub(self, sub: dict) -> dict:
        """One sub-op of a coalesced step_ops batch. A failing sub-op is
        reported in its slot without aborting the rest — sub-ops touch
        independent tables, and the batch (one seq) must leave a
        deterministic replayable reply either way."""
        try:
            return {"ok": self._run_handler(sub["op"],
                                            sub.get("args") or {})}
        except Exception as e:                         # noqa: BLE001
            return {"err": f"{type(e).__name__}: {e}"}


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class _Pending:
    __slots__ = ("rid", "parts", "fut", "attempts", "budget", "timeout",
                 "deadline")

    def __init__(self, rid: int, parts: list, fut: Future, attempts: int,
                 timeout: float):
        self.rid, self.parts, self.fut = rid, parts, fut
        self.attempts, self.timeout = attempts, timeout
        self.budget = attempts + 1            # for the error message
        self.deadline: float | None = None    # set when (re)sent


class RpcClient:
    """Pipelined caller with reconnect + bounded retry/backoff.

    ``call_async(op, ...)`` returns a :class:`Future` immediately; many
    may be outstanding on the one connection. ``call`` is the blocking
    wrapper. Futures fail with :class:`RpcError` when the remote handler
    raised (no retry — the server is alive) and
    :class:`PSUnavailableError` when the endpoint cannot be reached /
    answered within ``retries + 1`` attempts. ``coalesce(op, ...)``
    buffers sub-ops for one ``step_ops`` frame; ``flush()`` ships them.
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 retries: int = 3, backoff: float = 0.2):
        self.host, self.port = host, int(port)
        self.timeout = float(timeout)
        self.retries = int(retries)
        self.backoff = float(backoff)
        self._sock: socket.socket | None = None
        self._cond = threading.Condition()
        self._client_id = uuid.uuid4().hex
        self._rid = 0
        self._pending: dict[int, _Pending] = {}
        self._io_thread: threading.Thread | None = None
        self._closing = False
        self._coal: list[tuple[str, dict, Future]] = []
        self._coal_keys: set = set()
        self._coal_bytes = 0
        self._coal_mutating = False
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.frames_sent = 0
        self.frames_recv = 0

    @property
    def endpoint(self) -> tuple[str, int]:
        return (self.host, self.port)

    # -- connection management (io thread owns recovery) ---------------------

    def _connect(self, timeout: float) -> socket.socket:
        s = socket.create_connection((self.host, self.port), timeout=timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(self.timeout)   # mid-frame stall bound; idle uses select
        return s

    def _close_sock_locked(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self):
        with self._cond:
            self._closing = True
            self._close_sock_locked()
            pend = list(self._pending.values())
            self._pending.clear()
            coal = [f for _, _, f in self._coal]
            self._coal, self._coal_keys = [], set()
            self._cond.notify_all()
        err = PSUnavailableError(
            f"client for {self.host}:{self.port} closed")
        for p in pend:
            p.fut.set_exception(err)
        for f in coal:
            f.set_exception(err)
        t = self._io_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def _ensure_io_locked(self):
        if self._io_thread is None or not self._io_thread.is_alive():
            self._io_thread = threading.Thread(
                target=self._io_loop, daemon=True,
                name=f"rpc-io-{self.host}:{self.port}")
            self._io_thread.start()

    def _io_loop(self):
        rbuf = wire.RecvBuffer()
        while True:
            with self._cond:
                while (not self._closing and self._sock is None
                       and not self._pending):
                    self._cond.wait()
                if self._closing:
                    return
                sock = self._sock
            if sock is None:
                self._recover()
                continue
            try:
                readable, _, _ = select.select([sock], [], [], 0.25)
            except (OSError, ValueError):
                readable = None    # socket closed under us
            if readable is None or not readable:
                if readable is None:
                    with self._cond:
                        if self._sock is sock:
                            self._close_sock_locked()
                else:
                    self._check_deadlines()
                continue
            try:
                rid, view = wire.recv_frame_tagged(sock, rbuf)
            except (OSError, wire.WireError):
                with self._cond:
                    if self._sock is sock:
                        self._close_sock_locked()
                continue
            self.bytes_recv += len(view) + wire._HEADER2.size
            self.frames_recv += 1
            try:
                reply = wire.decode(view)
            except Exception:                          # noqa: BLE001
                with self._cond:
                    if self._sock is sock:
                        self._close_sock_locked()
                continue
            with self._cond:
                p = self._pending.pop(rid, None)
            if p is None:
                continue               # late reply for a timed-out request
            if "err" in reply:
                p.fut.set_exception(RpcError(reply["err"]))
            else:
                p.fut.set_result(reply["ok"])

    def _check_deadlines(self):
        now = time.monotonic()
        expired = []
        with self._cond:
            for p in self._pending.values():
                if p.deadline is not None and now > p.deadline:
                    expired.append(p)
            if not expired:
                return
            # a request timed out on a live-looking socket: treat the
            # connection as wedged — recovery reconnects + resends
            self._close_sock_locked()
            failed = self._charge_locked(
                expired, socket.timeout(f"no reply in {expired[0].timeout}s"))
        self._fail(failed)

    def _charge_locked(self, pendings, err) -> list:
        """Charge one attempt to each pending; return the exhausted ones
        (removed from the map) for the caller to fail outside the lock."""
        failed = []
        for p in pendings:
            p.attempts -= 1
            if p.attempts < 0:
                self._pending.pop(p.rid, None)
                failed.append((p, err))
        return failed

    def _fail(self, failed):
        for p, err in failed:
            p.fut.set_exception(PSUnavailableError(
                f"PS at {self.host}:{self.port} unreachable "
                f"after {p.budget} attempts: "
                f"{type(err).__name__}: {err}"))

    def _recover(self):
        """Reconnect with backoff and resend every pending request in rid
        order (send order == apply order; already-applied ones are replay
        -suppressed server-side). Each failed round charges one attempt."""
        round_ = 0
        while True:
            with self._cond:
                if self._closing:
                    return
                if not self._pending:
                    return            # nothing to resend; connect lazily
            if round_:
                time.sleep(min(self.backoff * (2 ** (round_ - 1)), 2.0))
            try:
                sock = self._connect(self.timeout)
            except OSError as e:
                with self._cond:
                    failed = self._charge_locked(
                        list(self._pending.values()), e)
                self._fail(failed)
                round_ += 1
                continue
            with self._cond:
                if self._closing:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return
                self._sock = sock
                try:
                    for rid in sorted(self._pending):
                        p = self._pending[rid]
                        self._send_locked(p)
                except (OSError, wire.WireError) as e:
                    self._close_sock_locked()
                    failed = self._charge_locked(
                        list(self._pending.values()), e)
                else:
                    return
            self._fail(failed)
            round_ += 1

    def _send_locked(self, p: _Pending):
        n = wire.send_frame_parts(self._sock, p.rid, p.parts)
        self.bytes_sent += n
        self.frames_sent += 1
        p.deadline = time.monotonic() + p.timeout

    # -- request submission --------------------------------------------------

    def _submit_locked(self, msg: dict, mutating: bool,
                       _timeout: float | None,
                       _retries: int | None) -> Future:
        timeout = self.timeout if _timeout is None else float(_timeout)
        retries = self.retries if _retries is None else int(_retries)
        self._rid += 1
        rid = self._rid
        if mutating:
            msg["seq"] = rid
            msg["client"] = self._client_id
        parts = wire.encode_parts(msg)
        fut: Future = Future()
        p = _Pending(rid, parts, fut, retries, timeout)
        self._pending[rid] = p
        self._ensure_io_locked()
        if self._sock is not None:
            try:
                self._send_locked(p)
            except (OSError, wire.WireError):
                self._close_sock_locked()   # io thread recovers + resends
        self._cond.notify_all()
        return fut

    def call_async(self, op: str, _mutating: bool = False,
                   _timeout: float | None = None,
                   _retries: int | None = None, **args) -> Future:
        """Send now, return a Future. Flushes any coalesced buffer first
        so direct traffic never overtakes buffered sub-ops."""
        with self._cond:
            if self._closing:
                raise PSUnavailableError(
                    f"client for {self.host}:{self.port} closed")
            self._flush_locked()
            return self._submit_locked({"op": op, "args": args},
                                       _mutating, _timeout, _retries)

    def call(self, op: str, _mutating: bool = False,
             _timeout: float | None = None, _retries: int | None = None,
             **args):
        fut = self.call_async(op, _mutating, _timeout, _retries, **args)
        return self.result(fut, _timeout, _retries)

    def result(self, fut: Future, _timeout: float | None = None,
               _retries: int | None = None):
        """Await one of this client's futures; the deadline is a safety
        net over the io thread's own timeout/retry machinery."""
        timeout = self.timeout if _timeout is None else float(_timeout)
        retries = self.retries if _retries is None else int(_retries)
        budget = (timeout + 2.5) * (retries + 1) \
            + sum(min(self.backoff * (2 ** k), 2.0) for k in range(retries + 1))
        try:
            return fut.result(timeout=budget)
        except (FutTimeoutError, CancelledError) as e:
            raise PSUnavailableError(
                f"PS at {self.host}:{self.port} gave no reply within "
                f"{budget:.1f}s: {type(e).__name__}") from e

    # -- op coalescing -------------------------------------------------------

    def coalesce(self, op: str, _mutating: bool = False, **args) -> Future:
        """Buffer a sub-op into the next ``step_ops`` frame. The returned
        future resolves when the flushed batch's reply arrives — anything
        that *waits* on it must call :meth:`flush` first (``call`` /
        ``call_async`` flush implicitly). Auto-flushes when the buffer
        holds an op for the same ``(op, table)`` key (per-table streams
        must keep one op per frame in order), or on size caps."""
        key = (op, args.get("table"))
        with self._cond:
            if self._closing:
                raise PSUnavailableError(
                    f"client for {self.host}:{self.port} closed")
            if (key in self._coal_keys
                    or len(self._coal) >= COALESCE_MAX_OPS
                    or self._coal_bytes >= COALESCE_MAX_BYTES):
                self._flush_locked()
            fut: Future = Future()
            self._coal.append((op, args, fut))
            self._coal_keys.add(key)
            self._coal_bytes += wire.tree_nbytes(args)
            self._coal_mutating = self._coal_mutating or _mutating
        return fut

    def flush(self):
        """Ship the coalesced buffer (if any) as one step_ops frame."""
        with self._cond:
            self._flush_locked()

    def _flush_locked(self):
        if not self._coal:
            return
        ops = [{"op": op, "args": args} for op, args, _ in self._coal]
        subs = [f for _, _, f in self._coal]
        mutating = self._coal_mutating
        self._coal, self._coal_keys = [], set()
        self._coal_bytes, self._coal_mutating = 0, False
        batch = self._submit_locked({"op": "step_ops", "args": {"ops": ops}},
                                    mutating, None, None)
        batch.add_done_callback(
            lambda f, subs=subs: _distribute_batch(f, subs))

    def ping(self, timeout: float = 1.0, retries: int = 0) -> bool:
        """Liveness probe; False instead of raising on an unreachable PS."""
        try:
            self.call("ping", _timeout=timeout, _retries=retries)
            return True
        except (PSUnavailableError, RpcError):
            return False


def _distribute_batch(batch: Future, subs: list[Future]):
    """Resolve per-sub-op futures from one step_ops batch reply."""
    err = batch.exception()
    if err is not None:
        for f in subs:
            f.set_exception(err)
        return
    results = batch.result()
    for f, r in zip(subs, results):
        if isinstance(r, dict) and "err" in r:
            f.set_exception(RpcError(r["err"]))
        else:
            f.set_result(r.get("ok") if isinstance(r, dict) else r)
