"""The port's PS wire and RPC layer (repro_torch/net/wire.py, rpc.py)
against the JAX package's (repro/net): the same frames byte for byte, the
numpy blockscale codec bit for bit with JAX's and with the port's own
codec (the CUDA kernels' plain version, NaN blocks and subnormals
included), a port client against a JAX server and the other way round,
and the RPC semantics of ``tests/test_net.py``: timeouts, retries,
reconnect, remote errors, out-of-order completion, op coalescing and
at-most-once replay suppression.

Tolerance: none. Every comparison is exact (bytes, bits, counts)."""
import dataclasses
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro.net import rpc as jrpc
from repro.net import wire as jwire

from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.kernels import ref
from repro_torch.net import wire
from repro_torch.net.rpc import (PSUnavailableError, RpcClient, RpcError,
                                 RpcServer)

TREE = {
    "a": np.arange(12, dtype=np.int64).reshape(3, 4),
    "b": {"c": np.float32(0).reshape(()) + 1.5,
          "empty": np.zeros((0, 8), np.float32),
          "f16": np.arange(6, dtype=np.float16)},
    "scalars": [1, 2.5, "name", None, True, False],
    "tup": (np.int32(7), [np.ones(3, np.float64)]),
}


def _pair_recv(send, recv):
    """Run ``send(a)`` on a thread and ``recv(b)`` here over a
    socketpair."""
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=send, args=(a,))
        t.start()
        out = recv(b)
        t.join()
        return out
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# framing and codec: the JAX package's bytes
# ---------------------------------------------------------------------------

def test_frame_roundtrip_over_socketpair():
    payload = b"x" * 100_000
    got = _pair_recv(lambda a: wire.send_frame(a, payload), wire.recv_frame)
    assert got == payload


@pytest.mark.parametrize("sender,receiver", [(wire, jwire), (jwire, wire)],
                         ids=["port_to_jax", "jax_to_port"])
def test_frames_cross_packages(sender, receiver):
    """A frame either package sends, the other receives, legacy and
    rid-tagged alike."""
    parts = sender.encode_parts(TREE)
    rid, view = _pair_recv(
        lambda a: sender.send_frame_parts(a, 42, parts),
        lambda b: receiver.recv_frame_tagged(b, receiver.RecvBuffer(16)))
    assert rid == 42
    out = receiver.decode(view)
    np.testing.assert_array_equal(out["a"], TREE["a"])
    assert out["scalars"] == TREE["scalars"]
    got = _pair_recv(lambda a: sender.send_frame(a, b"abc" * 7),
                     receiver.recv_frame)
    assert got == b"abc" * 7


def test_encoded_bytes_equal_jax():
    assert wire.encode(TREE) == jwire.encode(TREE)
    assert [bytes(p) for p in wire.encode_parts(TREE)] == \
        [bytes(p) for p in jwire.encode_parts(TREE)]
    assert wire.tree_nbytes(TREE) == jwire.tree_nbytes(TREE)
    # the tagged frame on the socket, header included
    frames = []
    for mod in (wire, jwire):
        frames.append(_pair_recv(
            lambda a, m=mod: m.send_frame_parts(a, 7, m.encode_parts(TREE)),
            lambda b: b.recv(1 << 20)))
    assert frames[0] == frames[1]


def test_frame_bad_magic_and_short_read():
    a, b = socket.socketpair()
    try:
        a.sendall(b"NOPE" + (8).to_bytes(8, "little"))
        with pytest.raises(wire.WireError, match="magic"):
            wire.recv_frame(b)
        # a peer dying mid-frame is a short read, never a garbage parse
        a.sendall(wire.MAGIC + (100).to_bytes(8, "little") + b"abc")
        a.close()
        with pytest.raises(wire.WireError, match="mid-frame"):
            wire.recv_frame(b)
    finally:
        b.close()


def test_tagged_frame_scatter_gather_roundtrip():
    a, b = socket.socketpair()
    buf = wire.RecvBuffer(initial=16)        # force growth
    tree = {"x": np.arange(1000, dtype=np.float32), "tag": "hello"}
    try:
        t = threading.Thread(target=wire.send_frame_parts,
                             args=(a, 42, wire.encode_parts(tree)))
        t.start()
        rid, view = wire.recv_frame_tagged(b, buf)
        t.join()
        assert rid == 42
        out = wire.decode(view)
        assert out["tag"] == "hello"
        # decoded arrays are owned — reusing the buffer can't corrupt them
        wire.send_frame_parts(a, 43, wire.encode_parts({"y": 0}))
        wire.recv_frame_tagged(b, buf)
        np.testing.assert_array_equal(out["x"], tree["x"])
    finally:
        a.close()
        b.close()


def test_codec_roundtrip_nested_tree():
    out = wire.decode(wire.encode(TREE))
    assert isinstance(out["tup"], tuple)           # tuples survive
    assert out["scalars"] == [1, 2.5, "name", None, True, False]
    assert out["scalars"][4] is True and out["scalars"][5] is False
    assert out["a"].dtype == np.int64
    np.testing.assert_array_equal(out["a"], TREE["a"])
    np.testing.assert_array_equal(out["b"]["f16"], TREE["b"]["f16"])
    assert out["b"]["empty"].shape == (0, 8)
    np.testing.assert_array_equal(out["tup"][1][0], np.ones(3, np.float64))
    # decode() copies out of the receive buffer: the arrays outlive it
    src = np.arange(100, dtype=np.float32)
    got = wire.decode(wire.encode({"x": src}))
    got["x"][0] = -1.0
    assert got["x"].flags["WRITEABLE"] and src[0] == 0.0
    with pytest.raises(wire.WireError, match="object"):
        wire.encode({"bad": np.array([object()])})


def test_spec_dict_roundtrip_and_jax_specs():
    spec = EmbeddingSpec(rows=64, dim=8, backend="host_lru", cache_rows=16,
                         staleness=2, dtype=torch.bfloat16)
    out = wire.spec_from_dict(wire.decode(wire.encode(
        wire.spec_to_dict(spec))))
    assert out == spec
    # a JAX spec's dict (numpy dtype name) is a port spec
    from repro.core.embedding_ps import EmbeddingSpec as JSpec
    js = JSpec(rows=64, dim=8, backend="host_lru", cache_rows=16,
               staleness=2)
    assert wire.spec_from_dict(jwire.spec_to_dict(js)) == \
        dataclasses.replace(spec, dtype=torch.float32)
    assert wire.spec_to_dict(dataclasses.replace(
        spec, dtype=torch.float32)) == jwire.spec_to_dict(js)


# ---------------------------------------------------------------------------
# the numpy blockscale codec: bit for bit with JAX's and the port's own
# ---------------------------------------------------------------------------

def _values(shape, case):
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(shape)
         * 10.0 ** rng.integers(-4, 4, shape)).astype(np.float32)
    flat = v.reshape(-1)
    if case == "nan":
        flat[min(3, flat.size - 1)] = np.nan
    elif case == "inf":
        flat[0] = np.inf
    elif case == "subnormal":
        flat[: flat.size // 2] *= np.float32(1e-40)
    elif case == "zeros":
        flat[:] = 0.0
    return v


@pytest.mark.parametrize("case", ["normal", "nan", "inf", "subnormal",
                                  "zeros"])
@pytest.mark.parametrize("shape", [(7,), (16, 8), (3, 128), (130,),
                                   (33, 16)])
def test_np_blockscale_matches_jax_and_the_port_codec(shape, case):
    v = _values(shape, case)
    comp, scale, _ = wire.np_blockscale_compress(v, block=128)
    jcomp, jscale, _ = jwire.np_blockscale_compress(v, block=128)
    np.testing.assert_array_equal(comp.view(np.uint16),
                                  jcomp.view(np.uint16))
    np.testing.assert_array_equal(scale.view(np.uint32),
                                  jscale.view(np.uint32))
    # the port's codec (the CUDA kernels' plain version), same bits
    tcomp, tscale = ref.blockscale_compress_ref(torch.from_numpy(v), 128)
    np.testing.assert_array_equal(comp.view(np.uint16),
                                  tcomp.numpy().view(np.uint16))
    np.testing.assert_array_equal(scale.view(np.uint32),
                                  tscale.numpy().view(np.uint32))
    out = wire.np_blockscale_decompress(comp, scale, shape)
    tout = ref.blockscale_decompress_ref(tcomp, tscale).reshape(-1)[
        :v.size].reshape(shape)
    np.testing.assert_array_equal(out.view(np.uint32),
                                  tout.numpy().view(np.uint32))
    # and the packed payload, through both packages' unpack
    p, jp = wire.lossy_pack(v), jwire.lossy_pack(v)
    assert wire.encode(p) == jwire.encode(jp)
    np.testing.assert_array_equal(wire.lossy_unpack(jp).view(np.uint32),
                                  out.view(np.uint32))


def test_lossy_pack_roundtrip_and_sizes():
    v = np.random.default_rng(1).standard_normal((40, 8)).astype(np.float32)
    p = wire.lossy_pack(v, block=128)
    out = wire.lossy_unpack(p)
    assert out.shape == v.shape
    np.testing.assert_allclose(out, v, rtol=2e-3, atol=1e-6)
    # fp16 payload + fp32 per-block scales: roughly half the raw bytes
    assert wire.payload_nbytes(p) < v.nbytes
    np.testing.assert_array_equal(wire.lossy_unpack(v), v)
    assert wire.payload_nbytes(v) == v.nbytes


# ---------------------------------------------------------------------------
# RPC semantics
# ---------------------------------------------------------------------------

def _echo_server(extra=None, server_cls=RpcServer):
    calls = {"n": 0}

    def bump(**kw):
        calls["n"] += 1
        return {"n": calls["n"], **kw}

    handlers = {"ping": lambda: {"pong": True},
                "echo": lambda **kw: kw,
                "bump": bump,
                "boom": lambda: (_ for _ in ()).throw(
                    ValueError("handler exploded"))}
    if extra:
        handlers.update(extra)
    srv = server_cls(handlers, mutating_ops={"bump"}).start()
    return srv, calls


@pytest.mark.parametrize("client_cls,server_cls", [
    (RpcClient, RpcServer), (RpcClient, jrpc.RpcServer),
    (jrpc.RpcClient, RpcServer)],
    ids=["port", "port_client_jax_server", "jax_client_port_server"])
def test_rpc_call_and_remote_error(client_cls, server_cls):
    srv, calls = _echo_server(server_cls=server_cls)
    try:
        c = client_cls("127.0.0.1", srv.port, timeout=5.0, retries=0)
        out = c.call("echo", x=np.arange(5, dtype=np.int32), s="hi")
        np.testing.assert_array_equal(out["x"], np.arange(5, dtype=np.int32))
        assert out["s"] == "hi"
        assert c.ping()
        # handler exceptions come back typed, the server stays up
        with pytest.raises(Exception, match="ValueError: handler exploded"):
            c.call("boom")
        with pytest.raises(Exception, match="unknown rpc op"):
            c.call("nope")
        assert c.call("echo", ok=1)["ok"] == 1       # still serving
        # coalesced sub-ops and a mutating op across the packages
        f1 = c.coalesce("echo", table="a", x=1)
        f2 = c.coalesce("bump", _mutating=True, table="b")
        c.flush()
        assert c.result(f1)["x"] == 1 and c.result(f2)["n"] == 1
        assert calls["n"] == 1
        assert c.bytes_sent > 0 and c.bytes_recv > 0
        c.close()
    finally:
        srv.stop()


def test_rpc_errors_are_typed():
    srv, _ = _echo_server()
    try:
        c = RpcClient("127.0.0.1", srv.port, timeout=5.0, retries=0)
        with pytest.raises(RpcError, match="ValueError"):
            c.call("boom")
        c.close()
    finally:
        srv.stop()


def test_rpc_unavailable_after_retries(free_port):
    c = RpcClient("127.0.0.1", free_port(), timeout=0.5, retries=1,
                  backoff=0.01)
    with pytest.raises(PSUnavailableError, match="after 2 attempts"):
        c.call("ping")
    assert c.ping() is False


def test_rpc_reconnects_after_server_restart():
    srv, _ = _echo_server()
    port = srv.port
    c = RpcClient("127.0.0.1", port, timeout=5.0, retries=4, backoff=0.05)
    assert c.call("echo", a=1)["a"] == 1
    srv.stop()
    deadline = time.time() + 10.0
    while True:
        try:
            srv2 = RpcServer({"echo": lambda **kw: kw}, port=port).start()
            break
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.05)
    try:
        assert c.call("echo", a=2)["a"] == 2
    finally:
        c.close()
        srv2.stop()


def test_rpc_replay_suppression_and_window():
    """A retried (client, seq) gets the cached reply, never a second
    apply — for any seq in the window of in-flight ones, not only the
    latest."""
    srv, calls = _echo_server()
    try:
        c = RpcClient("127.0.0.1", srv.port, timeout=5.0, retries=0)
        futs = [c.call_async("bump", _mutating=True) for _ in range(5)]
        assert [c.result(f)["n"] for f in futs] == [1, 2, 3, 4, 5]
        for seq in (1, 3, 5):                        # old AND new seqs
            reply = wire.decode(b"".join(srv._dispatch(
                {"op": "bump", "args": {}, "seq": seq,
                 "client": c._client_id})))
            assert reply["ok"]["n"] == seq           # the cached reply
        assert calls["n"] == 5                       # nothing re-applied
        assert c.call("bump", _mutating=True)["n"] == 6
        c.close()
    finally:
        srv.stop()


def test_rpc_retried_mutation_after_dropped_reply_not_double_applied():
    holder = {}

    def bump_cut(**kw):
        holder["calls"]["n"] += 1
        if holder["calls"]["n"] == 1:
            for conn in list(holder["srv"]._conns):  # sever BEFORE reply
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        return {"n": holder["calls"]["n"]}

    srv, calls = _echo_server({"bump_cut": bump_cut})
    holder["srv"], holder["calls"] = srv, calls
    try:
        c = RpcClient("127.0.0.1", srv.port, timeout=5.0, retries=3,
                      backoff=0.02)
        out = c.call("bump_cut", _mutating=True)
        assert out["n"] == 1 and calls["n"] == 1     # applied once
        assert c.call("echo", ok=1)["ok"] == 1       # connection recovered
        c.close()
    finally:
        srv.stop()


def test_rpc_pipelined_out_of_order_completion():
    ev = threading.Event()

    def slow():
        ev.wait(5.0)
        return {"slow": True}

    srv = RpcServer({"slow": slow, "echo": lambda **kw: kw,
                     "ping": lambda: {}},
                    concurrent_ops={"slow", "ping"}).start()
    try:
        c = RpcClient("127.0.0.1", srv.port, timeout=10.0, retries=0)
        f_slow = c.call_async("slow")
        futs = [c.call_async("echo", i=i) for i in range(8)]
        assert [c.result(f)["i"] for f in futs] == list(range(8))
        assert not f_slow.done()
        ev.set()
        assert c.result(f_slow)["slow"] is True
        c.close()
    finally:
        ev.set()
        srv.stop()


def test_rpc_coalesced_ops_ride_one_frame():
    srv, calls = _echo_server()
    try:
        c = RpcClient("127.0.0.1", srv.port, timeout=5.0, retries=0)
        c.call("echo", warm=1)                       # connection up
        before = c.frames_sent
        f1 = c.coalesce("echo", table="a", x=1)
        f2 = c.coalesce("bump", _mutating=True, table="b")
        f3 = c.coalesce("boom")
        c.flush()
        assert c.result(f1)["x"] == 1
        assert c.result(f2)["n"] == 1
        with pytest.raises(RpcError, match="handler exploded"):
            c.result(f3)                 # sub-op error isolated to its slot
        assert c.frames_sent == before + 1           # ONE frame for all 3
        # a direct call flushes buffered sub-ops first (order preserved)
        f4 = c.coalesce("bump", _mutating=True, table="b")
        out = c.call("bump", _mutating=True)
        assert c.result(f4)["n"] == 2 and out["n"] == 3
        c.close()
    finally:
        srv.stop()


def test_rpc_sockets_set_nodelay_and_stop_joins_threads():
    srv, _ = _echo_server()
    clients = [RpcClient("127.0.0.1", srv.port, timeout=5.0, retries=0)
               for _ in range(3)]
    for c in clients:
        assert c.call("echo", a=1)["a"] == 1
        assert c._sock.getsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY) != 0
    for conn in list(srv._conns):
        assert conn.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY) != 0
    threads = list(srv._threads) + [srv._accept_thread]
    srv.stop()
    for t in threads:
        assert not t.is_alive(), f"{t.name} leaked past stop()"
    for c in clients:
        c.close()
    srv2 = RpcServer({"echo": lambda **kw: kw}, port=srv.port).start()
    srv2.stop()


def test_rpc_concurrent_clients():
    srv, _ = _echo_server()
    errs = []

    def worker(i):
        try:
            c = RpcClient("127.0.0.1", srv.port, timeout=10.0, retries=0)
            for j in range(20):
                out = c.call("echo", i=i, j=j)
                assert (out["i"], out["j"]) == (i, j)
            c.close()
        except Exception as e:                        # noqa: BLE001
            errs.append(e)

    try:
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not errs and not any(t.is_alive() for t in ts)
    finally:
        srv.stop()
