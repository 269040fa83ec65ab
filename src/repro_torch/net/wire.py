"""The PS wire format (copy of ``repro/net/wire.py``): framing, an
array-tree codec, and the numpy side of the paper's §4.2.3 blockscale value
compression. Numpy and the standard library only, so a frame's bytes are
the JAX package's, byte for byte: a client of either package talks to a
server of the other.

* Frames are ``MAGIC + u64 length + payload`` on a stream socket — the
  length prefix is the whole protocol, so a half-written frame (a killed
  peer) is detected as a short read, never a parse of garbage.
* The payload codec serializes the same trees the checkpoint blobs hold
  (nested dicts/lists of numpy arrays + scalars): a json header describing
  the structure, then the raw little-endian array buffers concatenated —
  serialisation is a memory copy, exactly the checkpoint's
  manifest+data.bin layout but on a socket.
* ``np_blockscale_compress`` mirrors the blockscale codec in numpy,
  bit-for-bit (same fp32 scale arithmetic, same fp16 round-to-nearest
  cast, NaN blocks and subnormals included), so a remote table behind the
  lossy wire is numerically identical to the in-process
  :class:`~repro_torch.core.backend.CompressedWireBackend`, whose codec is
  the ``blockscale_compress`` / ``blockscale_decompress`` CUDA kernels —
  tested in ``tests/test_torch_net.py``.
"""
from __future__ import annotations

import dataclasses
import json
import socket
import struct

import numpy as np

MAGIC = b"PSR1"
_HEADER = struct.Struct("<4sQ")       # magic + payload length
MAGIC2 = b"PSR2"                      # rid-tagged frames (pipelined RPC)
_HEADER2 = struct.Struct("<4sQQ")     # magic + rid + payload length
MAX_FRAME = 1 << 33                   # 8 GiB sanity bound on one message

KAPPA = 32_768.0                      # keep in sync with core/compression.py


class WireError(ConnectionError):
    """Framing/codec violation (bad magic, truncated frame, unknown node)."""


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

def send_frame(sock: socket.socket, payload: bytes) -> int:
    header = _HEADER.pack(MAGIC, len(payload))
    sock.sendall(header + payload)
    return len(header) + len(payload)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise WireError(f"peer closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> bytes:
    magic, length = _HEADER.unpack(recv_exact(sock, _HEADER.size))
    if magic != MAGIC:
        raise WireError(f"bad frame magic {magic!r}")
    if length > MAX_FRAME:
        raise WireError(f"frame length {length} exceeds MAX_FRAME")
    return recv_exact(sock, length)


# ---------------------------------------------------------------------------
# Tagged framing (the pipelined transport): rid in the frame header so the
# receiver demuxes replies without decoding payloads, scatter-gather send
# over the codec's buffer list (no intermediate join), and a reusable
# receive buffer so steady-state traffic allocates nothing per frame.
# ---------------------------------------------------------------------------

def send_frame_parts(sock: socket.socket, rid: int, parts) -> int:
    """Send one rid-tagged frame from a list of buffers via ``sendmsg``
    (scatter-gather — the payload is never joined into one bytes)."""
    views = [memoryview(p).cast("B") for p in parts]
    length = sum(len(v) for v in views)
    if length > MAX_FRAME:
        raise WireError(f"frame length {length} exceeds MAX_FRAME")
    views.insert(0, memoryview(_HEADER2.pack(MAGIC2, rid, length)))
    total = length + _HEADER2.size
    sent = 0
    while sent < total:
        n = sock.sendmsg(views)
        if n <= 0:
            raise WireError("sendmsg made no progress")
        sent += n
        if sent >= total:
            break
        # drop fully-sent buffers, slice the partially-sent one
        while n > 0:
            if n >= len(views[0]):
                n -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][n:]
                n = 0
    return total


class RecvBuffer:
    """A growable receive buffer one connection reuses across frames —
    ``recv_frame_tagged`` reads payloads into it with ``recv_into`` (no
    per-frame allocation once warm). ``decode`` copies arrays out, so the
    returned view only has to live until the next recv."""

    def __init__(self, initial: int = 1 << 16):
        self._buf = bytearray(initial)

    def view(self, n: int) -> memoryview:
        if len(self._buf) < n:
            self._buf = bytearray(max(n, 2 * len(self._buf)))
        return memoryview(self._buf)[:n]


def recv_into_exact(sock: socket.socket, view: memoryview):
    got = 0
    n = len(view)
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise WireError(f"peer closed mid-frame ({got}/{n} bytes)")
        got += r


def recv_frame_tagged(sock: socket.socket,
                      buf: RecvBuffer) -> tuple[int, memoryview]:
    """Read one rid-tagged frame into ``buf``; returns ``(rid, payload)``.
    The payload view aliases the reusable buffer — decode (which copies
    arrays out) before the next read."""
    magic, rid, length = _HEADER2.unpack(recv_exact(sock, _HEADER2.size))
    if magic != MAGIC2:
        raise WireError(f"bad frame magic {magic!r}")
    if length > MAX_FRAME:
        raise WireError(f"frame length {length} exceeds MAX_FRAME")
    view = buf.view(int(length))
    recv_into_exact(sock, view)
    return int(rid), view


# ---------------------------------------------------------------------------
# Array-tree codec
# ---------------------------------------------------------------------------

def _enc_node(node, bufs: list):
    if node is None or isinstance(node, (bool, int, float, str)):
        return node if not isinstance(node, bool) else {"t": "b", "v": node}
    if isinstance(node, dict):
        return {"t": "d", "v": {str(k): _enc_node(v, bufs)
                                for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"t": "l" if isinstance(node, list) else "t",
                "v": [_enc_node(v, bufs) for v in node]}
    a = np.asarray(node)
    if a.dtype == object:
        raise WireError(f"cannot encode object array {node!r}")
    # memoryview over the array's own buffer — no tobytes() copy; the view
    # keeps the (contiguous) array alive for as long as the parts list does
    # (cast rejects zero-size shapes, so empty arrays ship an empty buffer)
    raw = (memoryview(np.ascontiguousarray(a)).cast("B") if a.size
           else memoryview(b""))
    bufs.append(raw)
    return {"t": "a", "d": str(a.dtype), "s": list(a.shape), "n": len(raw)}


def _dec_node(node, bufs: list[memoryview], pos: list[int]):
    if not isinstance(node, dict):
        return node
    t = node["t"]
    if t == "b":
        return bool(node["v"])
    if t == "d":
        return {k: _dec_node(v, bufs, pos) for k, v in node["v"].items()}
    if t in ("l", "t"):
        seq = [_dec_node(v, bufs, pos) for v in node["v"]]
        return seq if t == "l" else tuple(seq)
    if t == "a":
        raw = bufs[pos[0]]
        pos[0] += 1
        arr = np.frombuffer(raw, dtype=node["d"]).reshape(node["s"])
        return arr.copy()      # decouple from the receive buffer
    raise WireError(f"unknown wire node tag {t!r}")


def encode_parts(tree) -> list:
    """Tree -> list of payload buffers (header + raw array views, never
    joined). Feed to :func:`send_frame_parts` for a scatter-gather send,
    or ``b"".join(...)`` for the legacy one-bytes payload."""
    bufs: list = []
    header = json.dumps(_enc_node(tree, bufs),
                        separators=(",", ":")).encode()
    parts = [struct.pack("<I", len(header)), header]
    parts.extend(bufs)
    return parts


def encode(tree) -> bytes:
    """Tree of dicts/lists/scalars/arrays -> one bytes payload."""
    return b"".join(encode_parts(tree))


def decode(payload):
    """Inverse of :func:`encode`; accepts bytes or a memoryview (the
    tagged-frame receive path decodes straight out of the reusable
    receive buffer — arrays are copied out, so the view may be reused)."""
    (hlen,) = struct.unpack_from("<I", payload, 0)
    header = json.loads(bytes(payload[4: 4 + hlen]))
    view = memoryview(payload)
    bufs: list[memoryview] = []
    off = 4 + hlen

    def _collect(node):
        nonlocal off
        if isinstance(node, dict):
            if node.get("t") == "a":
                bufs.append(view[off: off + node["n"]])
                off += node["n"]
            elif node.get("t") == "d":
                for v in node["v"].values():
                    _collect(v)
            elif node.get("t") in ("l", "t"):
                for v in node["v"]:
                    _collect(v)
    _collect(header)
    return _dec_node(header, bufs, [0])


def tree_nbytes(tree) -> int:
    """Array payload bytes of a tree (codec framing/header excluded) — the
    honest bytes-on-wire gauge the benchmarks report."""
    total = 0
    for leaf in _iter_leaves(tree):
        total += np.asarray(leaf).nbytes
    return total


def _iter_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter_leaves(v)
    elif tree is not None and not isinstance(tree, (bool, int, float, str)):
        yield tree


# ---------------------------------------------------------------------------
# Blockscale fp16 values on the wire (numpy mirror of core/compression.py)
# ---------------------------------------------------------------------------

def np_blockscale_compress(v: np.ndarray, block: int = 128):
    """fp32 array -> (fp16 blocks, fp32 per-block scales, orig shape).
    Same arithmetic as the jnp reference: linf per block, scale =
    KAPPA / max(linf, 1e-30) in fp32, fp16 cast (round-to-nearest-even in
    both numpy and XLA), so the roundtrip is bit-identical."""
    v = np.asarray(v, np.float32)
    orig_shape = v.shape
    flat = v.reshape(-1)
    pad = (-flat.size) % block
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, block)
    linf = np.max(np.abs(blocks), axis=-1, keepdims=True)
    scale = (np.float32(KAPPA) / np.maximum(linf, np.float32(1e-30))) \
        .astype(np.float32)
    comp = (blocks * scale).astype(np.float16)
    return comp, scale[:, 0], orig_shape


def np_blockscale_decompress(comp, scale, orig_shape):
    blocks = comp.astype(np.float32) / np.asarray(scale, np.float32)[:, None]
    n = 1
    for s in orig_shape:
        n *= int(s)
    return blocks.reshape(-1)[:n].reshape(orig_shape)


def lossy_pack(v: np.ndarray, block: int = 128) -> dict:
    """Value payload for the lossy wire: fp16 blocks + fp32 scales."""
    comp, scale, shape = np_blockscale_compress(v, block)
    return {"__bs__": 1, "c": comp, "s": scale,
            "shape": [int(x) for x in shape]}


def lossy_unpack(payload) -> np.ndarray:
    """Inverse of :func:`lossy_pack`; raw fp32 arrays pass through."""
    if isinstance(payload, dict) and payload.get("__bs__"):
        return np_blockscale_decompress(payload["c"], payload["s"],
                                        tuple(payload["shape"]))
    return np.asarray(payload, np.float32)


def payload_nbytes(payload) -> int:
    if isinstance(payload, dict) and payload.get("__bs__"):
        return int(np.asarray(payload["c"]).nbytes
                   + np.asarray(payload["s"]).nbytes)
    return int(np.asarray(payload).nbytes)


# ---------------------------------------------------------------------------
# EmbeddingSpec <-> wire dict (all-primitive; dtype travels as its name, the
# torch dtype's, which is the numpy name the JAX package sends)
# ---------------------------------------------------------------------------

def spec_to_dict(spec) -> dict:
    d = dataclasses.asdict(spec)
    d["dtype"] = str(d["dtype"]).removeprefix("torch.")
    return d


def spec_from_dict(d: dict):
    import torch

    from repro_torch.core.embedding_ps import EmbeddingSpec
    d = dict(d)
    d["dtype"] = getattr(torch, str(d["dtype"]))
    return EmbeddingSpec(**d)
