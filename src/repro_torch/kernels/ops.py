"""Public wrappers around the port's CUDA kernels (the counterpart of
``repro/kernels/ops.py``).

Tensors that lie on the CPU go to the plain torch version in ``ref``; that
is the only way to it. Tensors on a CUDA device launch the kernel on the
current stream, or raise: wrong device mix, dtype, shape or layout is an
error, never a quiet detour through the plain version.

``embedding_sgd`` and ``fused_backward`` update their table in place on
both paths. Each wrapper counts its launches in ``<wrapper>.launches`` (a
plain int, raised by one per kernel launch and nowhere else), so a caller
can show that a run went through the kernel; the counts are raised under one
lock, since the pipelined trainer launches from several threads.
``fused_backward``'s kernel is two
grid passes on the stream (segment sums and leader election, then apply),
launched and counted as one.

``unique_bag_grouped``, ``blockscale_compress_grouped`` and
``blockscale_decompress_grouped`` serve a group of tables in one launch
(one per chunk of descriptors; the kwai-dlrm stage's 32 tables fit in
one). They launch the same kernels as the one-table wrappers, whose
one-table cases those are, and count on them: ``launches`` by real
launches and ``tables`` by the tables they served (``table_counts``).

``embedding_bag`` and ``unique_bag`` share one kernel: the occurrence-width
bag is the grouped bag kernel with the identity for ``dev``, so one launch
may pool tables of both kinds. Each kind counts its tables on its own
wrapper; a launch counts once, on ``unique_bag`` when it pooled any plan
table and on ``embedding_bag`` otherwise, so the launch counts add up to
the launches made.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import numpy as np
import torch

from repro_torch.kernels import build, ref

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
# C entry point -> (source in csrc/, argument types)
_SIGNATURES = {
    "persia_unique_bag_f32": ("bag", (_P, _P, _P, _P, _I64, _I, _I, _I, _I,
                                      _P)),
    "persia_unique_bag_grouped_f32": ("bag", (_P, _I, _P, _P)),
    "persia_fused_backward_f32": ("fused_backward",
                                  (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I64, _I, _I, _I, _I, _I, _F, _F, _I,
                                   _P)),
    "persia_blockscale_compress_f32": ("blockscale",
                                       (_P, _I64, _I, _P, _P, _P)),
    "persia_blockscale_compress_grouped_f32": ("blockscale",
                                               (_P, _I, _P, _P)),
    "persia_blockscale_decompress_f32": ("blockscale",
                                         (_P, _P, _I64, _I, _P, _P)),
    "persia_blockscale_decompress_grouped_f32": ("blockscale",
                                                 (_P, _I, _P, _P)),
    "persia_embedding_sgd_f32": ("embedding_sgd",
                                 (_P, _P, _P, _I64, _I, _I, _F, _P)),
    "persia_embedding_sgd_rows_per_warp": ("embedding_sgd", (_I64,)),
    "persia_launch_floor": ("embedding_sgd", (_I, _P)),
    "persia_flash_attention_fwd": ("flash_attention",
                                   (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _F, _I, _I, _I, _I, _P)),
}
_fns: dict = {}
_count_lock = threading.Lock()


def _count(fn, launches: int = 1, tables: int = 0) -> None:
    """Raise ``fn``'s launch (and table) counts, atomically: a wrapper may
    be called from several threads at once (the pipelined trainer's lookup
    and put stages both run the codec)."""
    with _count_lock:
        fn.launches += launches
        if tables:
            fn.tables += tables


def _flat_tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _flat_tensors(v)


def _costed(name: str, cost, meta):
    """A wrapper counted by ``launch.op_cost`` as one kernel ``name`` of
    ``cost(*args)`` = (operations, bytes), its own ops uncounted; in a
    count with every tensor on the ``meta`` device (:func:`_meta`) it
    returns ``meta(*args)``, the outputs' shapes, and launches nothing."""
    import functools

    def deco(f):
        @functools.wraps(f)
        def g(*args, **kwargs):
            ts = list(_flat_tensors((args, tuple(kwargs.values()))))
            if not ts:                       # an empty group: no kernel
                return f(*args, **kwargs)
            try:
                c = cost(*args, **kwargs)
            except (AttributeError, ArithmeticError, IndexError, TypeError,
                    ValueError):
                c = (0.0, 0.0)        # bad shapes: the wrapper says why
            with _kernel(name, *c):
                if _meta(*ts):
                    return meta(*args, **kwargs)
                return f(*args, **kwargs)
        return g
    return deco


def bag_work(n_slots: int, n_rows: int, n_out: int, n_index: int,
             D: int) -> tuple[float, float]:
    """(operations, bytes) of one bag call: each of ``n_rows`` distinct
    rows read once, each of ``n_out`` pooled rows written once, each of
    ``n_index`` indices read once; one fp32 add per element of each of
    ``n_slots`` valid bag slots. The bound of ``chip_smoke.py`` and the
    dry run's count."""
    return float(n_slots * D), float(n_rows * D * 4 + n_out * D * 4
                                     + n_index * 4)


def _bag_cost(table, dev, inv) -> tuple[float, float]:
    """:func:`bag_work` from the shapes, every index a distinct row."""
    (B, L), D = inv.shape, table.shape[1]
    rows = min(B * L, table.shape[0]) if dev is None else dev.shape[0]
    n_index = B * L + (0 if dev is None else dev.shape[0])
    return bag_work(B * L, rows, B, n_index, D)


def codec_cost(n: int, block: int) -> tuple[float, float]:
    """(operations, bytes) of one compress or decompress of n fp32
    elements in blocks of ``block``: 4 bytes read and 2 written per
    element (or the reverse) plus one 4-byte scale per block; compress
    does an abs-max and a product per element and a division per block,
    decompress one division per element (both about 2n operations)."""
    nb = -(-n // block)
    return float(2 * n + nb), float(n * 6 + nb * 4)


def _meta_empty(shape, dtype=torch.float32):
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


@contextlib.contextmanager
def _kernel(name: str, flops: float, nbytes: float):
    """One call of kernel ``name`` for ``launch.op_cost``: counted as one
    kernel of ``flops`` and ``nbytes`` (its bound's formula) while a count
    is open, the plain ops inside uncounted."""
    from repro_torch.launch import op_cost
    c = op_cost.active()
    if c is not None:
        c.kernel(name, flops, nbytes)
    with op_cost.suspended():
        yield


def _meta(*ts: torch.Tensor) -> bool:
    """The dry run's call: every tensor on the ``meta`` device while a
    ``launch.op_cost`` count is open. The wrapper then makes its outputs'
    shapes and launches nothing. Outside a count a meta tensor is one
    more device that is not a CUDA device: the wrapper raises."""
    from repro_torch.launch import op_cost
    ts = [t for t in ts if t is not None]
    return bool(ts) and op_cost.active() is not None and all(
        t.device.type == "meta" for t in ts)


def attended_pairs(Sq: int, Sk: int, causal: bool, window: int,
                   q_offset: int = 0) -> int:
    """(query, key) pairs the attention's masks leave, one head's work:
    per query at position p the keys k < Sk with k <= p (causal) and
    p - k < window (a window), counted in O(Sq)."""
    p = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(p + 1, Sk) if causal else np.full_like(p, Sk)
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros_like(p)
    return int(np.maximum(hi - lo, 0).sum())


def flash_cost(q, k, v, causal: bool, window: int, q_offset: int):
    """(operations, bytes) of one ``flash_attention_fwd`` call: 2 (Dh +
    Dv) a (query, key) pair the masks leave and head; q, k, v and o once
    and the fp32 logsumexp (``chip_smoke.py``'s bound)."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    pairs = attended_pairs(Sq, Sk, causal, window, q_offset)
    size = q.element_size()
    return (2.0 * B * Hq * (Dh + Dv) * pairs,
            size * (B * Hq * Sq * (Dh + Dv) + B * Hkv * Sk * (Dh + Dv))
            + 4.0 * B * Hq * Sq)


def fused_backward_cost(order, offsets, grads, apply_idx, apply_self: bool,
                        D: int, *, data: bool = False):
    """(operations, bytes) of one ``fused_backward`` call: the valid
    occurrence rows and the CSR read, the payload written, the live
    positions' gradient rows read (unless they are the payload itself),
    and the live table rows and accumulators read and written; a fp32 add
    per occurrence element, three operations per applied element (the
    step, its scaling, the row add) and two per squared element. From the
    shapes, every apply slot live and distinct; with ``data`` the live
    positions and distinct rows that ``apply_idx`` holds (a bound of this
    call's data). The kernel's own leader-election scratch is a choice of
    its design, not counted."""
    n_valid, cap = int(order.numel()), int(apply_idx.numel())
    n_live = n_rows = cap
    if data:
        live = apply_idx[apply_idx >= 0]
        n_live, n_rows = int(live.numel()), int(torch.unique(live).numel())
    nb = (n_valid * (D + 1) * 4 + offsets.numel() * 4 + cap * 4
          + cap * D * 4 + (0 if apply_self else n_live * D * 4)
          + n_rows * (D + 1) * 4 * 2)
    return float(n_valid * D + n_live * D * 5), float(nb)


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        source, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(source), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _all_on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_cuda(op: str, table: torch.Tensor, floats: dict | None = None,
                **index: torch.Tensor):
    """The CUDA kernels take an fp32 contiguous (V, D) table, fp32
    contiguous ``floats`` and int32 contiguous index arrays, all on one CUDA
    device."""
    floats = floats or {}
    devices = {t.device for t in (table, *floats.values(), *index.values())}
    if table.device.type != "cuda" or len(devices) != 1:
        raise ValueError(
            f"{op}: tensors must all lie on the CPU (plain version) or all "
            f"on one CUDA device (kernel); got "
            f"{sorted(str(d) for d in devices)}")
    if table.dtype != torch.float32:
        raise TypeError(f"{op}: the CUDA kernel takes an fp32 table, got "
                        f"{table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"{op}: table must be a contiguous (V, D) tensor")
    for k, t in floats.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{op}: {k} must be a contiguous fp32 tensor, "
                            f"got {t.dtype}")
    for k, t in index.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{op}: {k} must be a contiguous int32 tensor, "
                            f"got {t.dtype}")


def _launch(op: str, name: str, table: torch.Tensor, out: torch.Tensor,
            args: tuple):
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = _fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{op}: kernel launch failed with CUDA error "
                           f"{err}")
    return out


@_costed("embedding_bag",
         lambda table, ids: _bag_cost(table, None, ids),
         lambda table, ids: _meta_empty((ids.shape[0], table.shape[1]),
                                        table.dtype))
def embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(V, D) x (B, L) ids (< 0 = padding) -> (B, D) fused gather and sum
    pool. Port of ``repro.kernels.ops.embedding_bag``: on the card the
    grouped bag kernel's one-table case with the identity for ``dev``."""
    if ids.dim() != 2:
        raise ValueError(f"embedding_bag: ids must be (B, L), got "
                         f"{tuple(ids.shape)}")
    if _all_on_cpu(table, ids):
        return ref.embedding_bag_ref(table, ids)
    _check_cuda("embedding_bag", table, ids=ids)
    (V, D), (B, L) = table.shape, ids.shape
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    _launch("embedding_bag", "persia_unique_bag_f32", table, out,
            (table.data_ptr(), None, ids.data_ptr(), out.data_ptr(), V, -1,
             B, L, D))
    _count(embedding_bag, 1, 1)
    return out


@_costed("unique_bag", _bag_cost,
         lambda table, dev, inv: _meta_empty((inv.shape[0], table.shape[1]),
                                             table.dtype))
def unique_bag(table: torch.Tensor, dev: torch.Tensor,
               inv: torch.Tensor) -> torch.Tensor:
    """(V, D) x (U,) unique table rows x (B, L) inverse -> (B, D): the
    dedup-plan lookup (unique gather, inverse scatter, bag pool) in one
    pass; padding in ``inv`` or ``dev`` (< 0) adds nothing. Port of
    ``repro.kernels.ops.unique_bag``."""
    if dev.dim() != 1 or inv.dim() != 2:
        raise ValueError(f"unique_bag: dev must be (U,) and inv (B, L), got "
                         f"{tuple(dev.shape)} and {tuple(inv.shape)}")
    if _all_on_cpu(table, dev, inv):
        return ref.unique_bag_ref(table, dev, inv)
    _check_cuda("unique_bag", table, dev=dev, inv=inv)
    (V, D), (U,), (B, L) = table.shape, dev.shape, inv.shape
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    _launch("unique_bag", "persia_unique_bag_f32", table, out,
            (table.data_ptr(), dev.data_ptr(), inv.data_ptr(), out.data_ptr(),
             V, U, B, L, D))
    _count(unique_bag, 1, 1)
    return out


def _check_group(op: str, items) -> torch.device:
    """The grouped kernels take contiguous tensors of the given dtypes, all
    on one CUDA device: ``items`` of (name, tensor, dtype); returns the
    device. One pass, as the group's launch is meant to be cheap on the
    host too."""
    device = items[0][1].device
    for name, t, dtype in items:
        if t.device != device or device.type != "cuda":
            raise ValueError(
                f"{op}: tensors must all lie on the CPU (plain version) or "
                f"all on one CUDA device (kernel); got {device} and "
                f"{t.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f"{op}: {name} must be a contiguous {dtype} "
                            f"tensor, got {t.dtype}")
    return device


def _launch_grouped(op: str, name: str, device: torch.device,
                    desc: list) -> int:
    """Launch a grouped kernel on its host descriptor rows (int64 each);
    returns the launches it made."""
    rows = np.asarray(desc, dtype=np.int64).reshape(len(desc), -1)
    made = np.zeros(1, dtype=np.int32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _fn(name)(rows.ctypes.data, len(desc), made.ctypes.data,
                        stream)
    if err != 0:
        raise RuntimeError(f"{op}: kernel launch failed with CUDA error "
                           f"{err}")
    return int(made[0])


@_costed("unique_bag",
         lambda tables, devs, invs, flat=None: tuple(map(sum, zip(
             *[_bag_cost(t, d, i) for t, d, i in zip(tables, devs, invs)],
             (0.0, 0.0)))),
         lambda tables, devs, invs, flat=None: [
             _meta_empty((i.shape[0], t.shape[1]))
             for t, i in zip(tables, invs)])
def unique_bag_grouped(tables, devs, invs, flat=None) -> list[torch.Tensor]:
    """:func:`unique_bag` of every table of a group in ONE launch (one per
    chunk of descriptors): per table t, (V_t, D_t) x (U_t,) dev x (B_t,
    L_t) inv -> (B_t, D_t). Tables may differ in every size. A dev of
    ``None`` is the identity (``arange(V_t)``): the table holds the plan's
    unique rows themselves. ``flat[t]`` marks an occurrence-width table,
    whose pool is :func:`embedding_bag` of ``(tables[t], invs[t])`` (its
    dev must be ``None``) and counts on that wrapper. Where every table
    has one B and one D, the outputs are the rows of one (T, B, D)
    buffer."""
    tables, devs, invs = list(tables), list(devs), list(invs)
    flat = [False] * len(tables) if flat is None else list(flat)
    if not len(tables) == len(devs) == len(invs) == len(flat):
        raise ValueError(f"unique_bag_grouped: {len(tables)} tables, "
                         f"{len(devs)} devs, {len(invs)} invs and "
                         f"{len(flat)} flat marks")
    if any(f and d is not None for d, f in zip(devs, flat)):
        raise ValueError("unique_bag_grouped: an occurrence-width (flat) "
                         "table takes no dev")
    for t, d, i in zip(tables, devs, invs):
        if t.dim() != 2 or (d is not None and d.dim() != 1) or i.dim() != 2:
            raise ValueError(
                "unique_bag_grouped: each table (V, D), dev (U,) or None, "
                f"inv (B, L); got {tuple(t.shape)}, "
                f"{None if d is None else tuple(d.shape)}, {tuple(i.shape)}")
    given = [x for x in (*tables, *devs, *invs) if x is not None]
    if not given:
        return []
    if _all_on_cpu(*given):
        return ref.unique_bag_grouped_ref(tables, devs, invs)
    device = _check_group("unique_bag_grouped", [
        x for t, d, i in zip(tables, devs, invs)
        for x in (("table", t, torch.float32), ("inv", i, torch.int32),
                  ("dev", d, torch.int32)) if x[1] is not None])
    shapes = {(int(i.shape[0]), int(t.shape[1]))
              for t, i in zip(tables, invs)}
    if len(shapes) == 1:
        (B, D), = shapes
        outs = list(torch.empty((len(tables), B, D), dtype=torch.float32,
                                device=device).unbind(0))
    else:
        outs = [torch.empty((int(i.shape[0]), int(t.shape[1])),
                            dtype=torch.float32, device=device)
                for t, i in zip(tables, invs)]
    desc = [(t.data_ptr(), 0 if d is None else d.data_ptr(), i.data_ptr(),
             o.data_ptr(), int(t.shape[0]),
             -1 if d is None else int(d.shape[0]), int(i.shape[0]),
             int(i.shape[1]), int(t.shape[1]))
            for t, d, i, o in zip(tables, devs, invs, outs)]
    n_flat = sum(1 for o, f in zip(outs, flat) if o.numel() and f)
    n_plan = sum(1 for o, f in zip(outs, flat) if o.numel() and not f)
    if n_flat + n_plan:
        made = _launch_grouped("unique_bag_grouped",
                               "persia_unique_bag_grouped_f32", device, desc)
        _count(unique_bag if n_plan else embedding_bag, made)
        _count(unique_bag, 0, n_plan)
        _count(embedding_bag, 0, n_flat)
    return outs


# (device, R) -> (2, R) int32 leader-election scratch of fused_backward's
# kernel: row 0 holds INT_MAX, row 1 holds -1 between calls (each call
# restores what it touched)
_fb_scratch: dict = {}
# a call's two launches go onto the stream together: another thread's call
# on the same scratch (an embedding-PS thread applying beside the trainer,
# or two PS threads of one process) must not land between them
_fb_lock = threading.Lock()


def _election_scratch(device: torch.device, R: int) -> torch.Tensor:
    """The per-row scratch of ``fused_backward``'s kernel on ``device``
    for tables of ``R`` rows, allocated and filled at the first call for
    that size (never inside a CUDA-graph capture: a capture that needs a new
    one raises). Calls sharing it must be ordered on one stream."""
    key = (device, R)
    buf = _fb_scratch.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"fused_backward: its scratch for tables of {R} rows is made "
                "at the first call; make one call before capturing a graph")
        buf = torch.empty((2, max(R, 1)), dtype=torch.int32, device=device)
        buf[0].fill_(torch.iinfo(torch.int32).max)
        buf[1].fill_(-1)
        _fb_scratch[key] = buf
    return buf


def fused_backward(table: torch.Tensor, acc: torch.Tensor | None,
                   order: torch.Tensor, offsets: torch.Tensor,
                   grads: torch.Tensor, apply_idx: torch.Tensor,
                   apply_g: torch.Tensor | None = None, *, lr: float,
                   eps: float, apply_self: bool = False) -> torch.Tensor:
    """Fused embedding backward (port of ``repro.kernels.ops.
    fused_backward``): segment-sum the occurrence gradients ``grads``
    (n_occ, D) to unique width through the plan's occurrence CSR (``order``
    (n,), ``offsets`` (U + 1,)), apply the row-wise adagrad step (sgd when
    ``acc`` is None) to ``table``/``acc`` in place at ``apply_idx`` (cap,)
    (-1 = no-op) with ``apply_g`` (cap, D), or with the fresh sums when
    ``apply_self``; returns the (cap, D) fp32 queue payload ``g_push``.

    Unlike the JAX version, which returns new arrays, the table and acc
    are updated in place, on both paths."""
    if table.dim() != 2 or grads.dim() != 2 or \
            grads.shape[1] != table.shape[1]:
        raise ValueError(f"fused_backward: table (R, D) and grads (n_occ, D) "
                         f"of one D, got {tuple(table.shape)} and "
                         f"{tuple(grads.shape)}")
    (R, D), cap = table.shape, int(apply_idx.shape[0])
    if apply_idx.dim() != 1 or order.dim() != 1 or offsets.dim() != 1:
        raise ValueError("fused_backward: apply_idx, order and offsets must "
                         "be 1-D")
    if acc is not None and tuple(acc.shape) != (R,):
        raise ValueError(f"fused_backward: acc must be ({R},), got "
                         f"{tuple(acc.shape)}")
    if not apply_self and (apply_g is None
                           or tuple(apply_g.shape) != (cap, D)):
        raise ValueError(f"fused_backward: apply_g must be ({cap}, {D}) "
                         "unless apply_self")
    given = {k: t for k, t in (("acc", acc), ("grads", grads),
                               ("apply_g", None if apply_self else apply_g))
             if t is not None}
    with _kernel("fused_backward", *fused_backward_cost(
            order, offsets, grads, apply_idx, apply_self, D)):
        if _meta(table, acc, order, offsets, grads, apply_idx, apply_g):
            return torch.empty((cap, D), dtype=torch.float32,
                               device="meta")
        if _all_on_cpu(table, order, offsets, apply_idx, *given.values()):
            return ref.fused_backward_ref(table, acc, order, offsets, grads,
                                          apply_idx, apply_g, lr=lr,
                                          eps=eps, apply_self=apply_self)
        return _fused_backward_cuda(table, acc, order, offsets, grads,
                                    apply_idx, apply_g, given, lr=lr,
                                    eps=eps, apply_self=apply_self)


def _fused_backward_cuda(table, acc, order, offsets, grads, apply_idx,
                         apply_g, given, *, lr, eps, apply_self):
    (R, D), cap = table.shape, int(apply_idx.shape[0])
    _check_cuda("fused_backward", table, floats=given, order=order,
                offsets=offsets, apply_idx=apply_idx)
    push = torch.empty((cap, D), dtype=torch.float32, device=table.device)
    if cap == 0 or D == 0:
        return push
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with _fb_lock:
        scratch = _election_scratch(table.device, R)
        try:
            _launch("fused_backward", "persia_fused_backward_f32", table,
                    push,
                    (table.data_ptr(), ptr(acc), order.data_ptr(),
                     offsets.data_ptr(), grads.data_ptr(),
                     apply_idx.data_ptr(),
                     ptr(None if apply_self else apply_g), push.data_ptr(),
                     scratch[0].data_ptr(), scratch[1].data_ptr(), R,
                     int(grads.shape[0]), int(order.shape[0]),
                     max(int(offsets.shape[0]) - 1, 0), cap, D, float(lr),
                     float(eps), int(bool(apply_self))))
        except RuntimeError:
            # launch 1 may have run without the apply that restores the
            # sentinels: the next call at this size starts from fresh
            # scratch
            _fb_scratch.pop((table.device, R), None)
            raise
    _count(fused_backward)
    return push


def _check_codec(op: str, **tensors: tuple[torch.Tensor, torch.dtype]):
    """The codec and attention kernels take contiguous tensors of the given
    dtypes, all on one CUDA device."""
    devices = {t.device for t, _ in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{op}: tensors must all lie on the CPU (plain version) or all "
            f"on one CUDA device (kernel); got "
            f"{sorted(str(d) for d in devices)}")
    for k, (t, dtype) in tensors.items():
        if t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f"{op}: {k} must be a contiguous {dtype} tensor, "
                            f"got {t.dtype}")


def _check_block(block) -> int:
    if int(block) != block or block < 1:
        raise ValueError(f"blockscale: block must be a positive int, got "
                         f"{block!r}")
    return int(block)


@_costed("blockscale_compress",
         lambda v, block=128: codec_cost(v.numel(), block),
         lambda v, block=128: (
             _meta_empty((-(-v.numel() // block), block), torch.float16),
             _meta_empty((-(-v.numel() // block),))))
def blockscale_compress(v: torch.Tensor, block: int = 128):
    """Any-shape fp32 ``v``, flattened and zero-padded to whole blocks of
    ``block`` -> ``(comp, scales)``: (n_blocks, block) fp16 and (n_blocks,)
    fp32, ``comp = fp16(v * s)`` with ``s = 32768 / max(max|v|, 1e-30)``
    per block. Port of ``repro.kernels.ops.blockscale_compress`` (block 128
    over (n, 128) blocks) that also takes the jnp codec's any ``block``
    (``repro.core.compression.blockscale_compress``); no 256-block tile."""
    block = _check_block(block)
    if _all_on_cpu(v):
        return ref.blockscale_compress_ref(v, block)
    _check_codec("blockscale_compress", v=(v, torch.float32))
    n = v.numel()
    n_blocks = -(-n // block)
    comp = torch.empty((n_blocks, block), dtype=torch.float16,
                       device=v.device)
    scales = torch.empty((n_blocks,), dtype=torch.float32, device=v.device)
    if n == 0:
        return comp, scales
    _launch("blockscale_compress", "persia_blockscale_compress_f32", v, comp,
            (v.data_ptr(), n, block, comp.data_ptr(), scales.data_ptr()))
    _count(blockscale_compress, 1, 1)
    return comp, scales


@_costed("blockscale_compress",
         lambda vs, block=128: tuple(map(sum, zip(*[codec_cost(
             v.numel(), b) for v, b in zip(vs, [block] * len(vs) if isinstance(
                 block, (int, np.integer)) else block)], (0.0, 0.0)))),
         lambda vs, block=128: [(
             _meta_empty((-(-v.numel() // b), b), torch.float16),
             _meta_empty((-(-v.numel() // b),))) for v, b in zip(
                 vs, [block] * len(vs) if isinstance(block, (int, np.integer))
                 else block)])
def blockscale_compress_grouped(vs, block=128) -> list[tuple]:
    """:func:`blockscale_compress` of every payload of a group in ONE
    launch (one per chunk of descriptors) -> ``[(comp, scales)]``.
    ``block`` is one block size for all or one per payload. The outputs
    are views of one fp16 and one fp32 buffer, each starting on a 16-byte
    boundary."""
    vs = list(vs)
    blocks = [_check_block(b) for b in (
        [block] * len(vs) if isinstance(block, (int, np.integer))
        else block)]
    if len(blocks) != len(vs):
        raise ValueError(f"blockscale_compress_grouped: {len(vs)} payloads "
                         f"and {len(blocks)} blocks")
    if not vs:
        return []
    if _all_on_cpu(*vs):
        return ref.blockscale_compress_grouped_ref(vs, blocks)
    device = _check_group("blockscale_compress_grouped",
                          [("v", v, torch.float32) for v in vs])
    n_blocks = [-(-v.numel() // b) for v, b in zip(vs, blocks)]
    # starts rounded up to 8 halves and 4 floats (16 bytes)
    c_at = np.cumsum([0] + [-(-k * b // 8) * 8
                            for k, b in zip(n_blocks, blocks)])
    s_at = np.cumsum([0] + [-(-k // 4) * 4 for k in n_blocks])
    c_buf = torch.empty(int(c_at[-1]), dtype=torch.float16, device=device)
    s_buf = torch.empty(int(s_at[-1]), dtype=torch.float32, device=device)
    res = [(c_buf[int(c):int(c) + k * b].view(k, b),
            s_buf[int(s):int(s) + k])
           for k, b, c, s in zip(n_blocks, blocks, c_at, s_at)]
    desc = [(v.data_ptr(), c.data_ptr(), s.data_ptr(), v.numel(), b)
            for v, (c, s), b in zip(vs, res, blocks)]
    served = sum(1 for v in vs if v.numel())
    if served:
        _count(blockscale_compress, _launch_grouped(
            "blockscale_compress_grouped",
            "persia_blockscale_compress_grouped_f32", device, desc), served)
    return res


@_costed("blockscale_decompress",
         lambda comp, scales, shape=None: codec_cost(comp.numel(),
                                                      comp.shape[1]),
         lambda comp, scales, shape=None: _meta_empty(
             comp.shape if shape is None else shape))
def blockscale_decompress(comp: torch.Tensor, scales: torch.Tensor,
                          shape=None) -> torch.Tensor:
    """(n_blocks, block) fp16 and (n_blocks,) fp32 scales -> fp32 ``comp /
    s`` (a true division): the (n_blocks, block) blocks, or with ``shape``
    the first ``prod(shape)`` elements in that shape (the inverse of the
    flatten and pad of :func:`blockscale_compress`). Port of
    ``repro.kernels.ops.blockscale_decompress``."""
    if comp.dim() != 2 or tuple(scales.shape) != (comp.shape[0],):
        raise ValueError(f"blockscale_decompress: comp (n_blocks, block) and "
                         f"scales (n_blocks,), got {tuple(comp.shape)} and "
                         f"{tuple(scales.shape)}")
    n_blocks, block = comp.shape
    shape = tuple(comp.shape) if shape is None else tuple(shape)
    n = 1
    for s in shape:
        n *= int(s)
    if n > comp.numel():
        raise ValueError(f"blockscale_decompress: shape {shape} holds more "
                         f"than the {comp.numel()} compressed elements")
    if _all_on_cpu(comp, scales):
        out = ref.blockscale_decompress_ref(comp, scales)
        return out.reshape(-1)[:n].reshape(shape)
    _check_codec("blockscale_decompress", comp=(comp, torch.float16),
                 scales=(scales, torch.float32))
    out = torch.empty(shape, dtype=torch.float32, device=comp.device)
    if n == 0:
        return out
    _launch("blockscale_decompress", "persia_blockscale_decompress_f32",
            comp, out, (comp.data_ptr(), scales.data_ptr(), n, int(block),
                        out.data_ptr()))
    _count(blockscale_decompress, 1, 1)
    return out


@_costed("blockscale_decompress",
         lambda comps, scales, outs: tuple(map(sum, zip(*[codec_cost(
             c.numel(), c.shape[1]) for c in comps], (0.0, 0.0)))),
         lambda comps, scales, outs: [
             o if isinstance(o, torch.Tensor) else _meta_empty(o)
             for o in outs])
def blockscale_decompress_grouped(comps, scales, outs) -> list[torch.Tensor]:
    """:func:`blockscale_decompress` of every table of a group in ONE
    launch (one per chunk of descriptors). ``outs[t]`` is either a shape
    (a new fp32 tensor of that shape is returned) or a contiguous fp32
    tensor that receives the first ``numel`` decompressed elements in
    place, as a put's payload does."""
    comps, scales, outs = list(comps), list(scales), list(outs)
    if not len(comps) == len(scales) == len(outs):
        raise ValueError(f"blockscale_decompress_grouped: {len(comps)} "
                         f"comps, {len(scales)} scales and {len(outs)} "
                         "outputs")
    # elements of each output asked for by shape (0 for a given tensor)
    sizes = [0 if isinstance(o, torch.Tensor) else math.prod(
        int(x) for x in o) for o in outs]
    for c, s, o, n in zip(comps, scales, outs, sizes):
        if c.dim() != 2 or tuple(s.shape) != (c.shape[0],):
            raise ValueError(
                "blockscale_decompress_grouped: comp (n_blocks, block) and "
                f"scales (n_blocks,), got {tuple(c.shape)} and "
                f"{tuple(s.shape)}")
        if isinstance(o, torch.Tensor):
            n = o.numel()
        if n > c.numel():
            raise ValueError(
                f"blockscale_decompress_grouped: an output of {n} elements "
                f"from {c.numel()} compressed elements")
    given = [*comps, *scales, *(o for o in outs
                                if isinstance(o, torch.Tensor))]
    if not given:
        return []
    if _all_on_cpu(*given):
        return ref.blockscale_decompress_grouped_ref(comps, scales, outs)
    device = _check_group("blockscale_decompress_grouped", [
        x for c, s, o in zip(comps, scales, outs)
        for x in (("comp", c, torch.float16), ("scales", s, torch.float32),
                  ("out", o, torch.float32)) if isinstance(x[1],
                                                          torch.Tensor)])
    # the outputs asked for by shape: views of one buffer, each starting on
    # a 16-byte boundary (the kernel's float4 stores)
    starts = np.cumsum([0] + [-(-n // 4) * 4 for n in sizes])
    buf = torch.empty(int(starts[-1]), dtype=torch.float32, device=device)
    res = [o if isinstance(o, torch.Tensor) else
           buf[int(a):int(a) + n].view(tuple(int(x) for x in o))
           for o, a, n in zip(outs, starts, sizes)]
    desc = [(c.data_ptr(), s.data_ptr(), o.data_ptr(), o.numel(),
             int(c.shape[1])) for c, s, o in zip(comps, scales, res)]
    served = sum(1 for o in res if o.numel())
    if served:
        _count(blockscale_decompress, _launch_grouped(
            "blockscale_decompress_grouped",
            "persia_blockscale_decompress_grouped_f32", device, desc),
            served)
    return res


def blockscale_roundtrip(v: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Compress then decompress: what a payload of ``v``'s shape reads after
    crossing the wire (fp32). Port of ``repro.kernels.ops.
    blockscale_roundtrip``."""
    comp, scales = blockscale_compress(v, block)
    return blockscale_decompress(comp, scales, v.shape)


def check_unique(ids) -> None:
    """Raise ValueError when ``ids`` hold duplicates among the valid (>= 0)
    entries: the occurrence-width misuse ``embedding_sgd`` cannot honour.
    The check reads a host copy of the ids (a copy from the card waits for
    it). Port of ``repro.kernels.embedding_sgd.check_unique``, with its
    message."""
    host = (ids.detach().cpu().numpy() if isinstance(ids, torch.Tensor)
            else np.asarray(ids)).reshape(-1)
    valid = host[host >= 0]
    if valid.size != np.unique(valid).size:
        uniq, counts = np.unique(valid, return_counts=True)
        dups = uniq[counts > 1][:8]
        raise ValueError(
            "embedding_sgd requires pre-aggregated unique ids (duplicate "
            f"ids last-write-win and drop gradients); got duplicates "
            f"{dups.tolist()} among {valid.size} valid ids. Segment-sum "
            "via a DedupPlan / compression.dedup_put first, or pass "
            "assume_unique=True if the rows are already aggregated.")


@_costed("embedding_sgd",
         lambda table, ids, grads, lr=1e-2, assume_unique=False: (
             2.0 * grads.numel(), float(ids.numel() * 4 + grads.numel() * 12)),
         lambda table, ids, grads, lr=1e-2, assume_unique=False: table)
def embedding_sgd(table: torch.Tensor, ids: torch.Tensor,
                  grads: torch.Tensor, lr: float = 1e-2,
                  assume_unique: bool = False) -> torch.Tensor:
    """Row-wise SGD scatter-apply, in place: ``table[ids[t]] += -lr *
    grads[t]`` where 0 <= ids[t] < V; -1 and ids >= V change nothing.
    table (V, D), ids (T,), grads (T, D); returns ``table``. Port of
    ``repro.kernels.ops.embedding_sgd`` (which returns a new table): the
    kernel's warps race on a repeated row, so unless ``assume_unique``
    vouches for the ids, :func:`check_unique` runs first and duplicates
    raise."""
    if table.dim() != 2 or ids.dim() != 1 or grads.dim() != 2 or \
            tuple(grads.shape) != (ids.shape[0], table.shape[1]):
        raise ValueError(f"embedding_sgd: table (V, D), ids (T,) and grads "
                         f"(T, D), got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)} and {tuple(grads.shape)}")
    if not assume_unique:
        check_unique(ids)
    if _all_on_cpu(table, ids, grads):
        return ref.embedding_sgd_ref(table, ids, grads, lr=lr)
    _check_cuda("embedding_sgd", table, floats={"grads": grads}, ids=ids)
    (V, D), T = table.shape, int(ids.shape[0])
    if T == 0 or D == 0:
        return table
    _launch("embedding_sgd", "persia_embedding_sgd_f32", table, table,
            (table.data_ptr(), ids.data_ptr(), grads.data_ptr(), V, T, D,
             float(lr)))
    _count(embedding_sgd)
    return table


def launch_floor(device, pdl: bool = False) -> None:
    """Launch an empty one-thread kernel on ``device``'s current stream, as
    a programmatic dependent (PDL) when ``pdl``: the fixed cost any launch
    pays, which ``chip_smoke.py`` times beside the kernels. It computes
    nothing, serves no path and counts no launch. Needs a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"launch_floor: needs a CUDA device, got {device}")
    with torch.cuda.device(device):
        err = _fn("persia_launch_floor")(
            int(pdl), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch_floor: kernel launch failed with CUDA "
                           f"error {err}")


_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """(B, Hq, Sq, Dh) x (B, Hkv, Sk, Dh) x (B, Hkv, Sk, Dv) -> ``(o, lse)``:
    causal and/or sliding-window GQA attention forward (query head h reads
    kv head h // (Hq // Hkv)) with an fp32 online softmax; ``o`` (B, Hq, Sq,
    Dv) in q's dtype, ``lse`` (B, Hq, Sq) fp32. The value head Dv may be
    narrower than the query/key head Dh (MLA: 192 and 128). Port of
    ``repro.kernels.ops.flash_attention_fwd``, plus ``q_offset`` (the first
    query row's position, as ``repro.models.flash.flash_attention`` takes
    it) and Dv; no block sizes and no padding: any Sq and Sk >= 1. The CUDA
    kernel takes fp32 or bf16, contiguous, Dh a multiple of 4 up to 192 and
    Dv a multiple of 4 up to min(Dh, 128); any other shape raises."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape[:3] != v.shape[:3] or k.shape[0] != q.shape[0] or \
            k.shape[3] != q.shape[3] or k.shape[1] == 0 or \
            q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"flash_attention_fwd: q (B, Hq, Sq, Dh), k (B, "
                         f"Hkv, Sk, Dh) and v (B, Hkv, Sk, Dv) with Hkv "
                         f"dividing Hq, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[2] == 0:
        raise ValueError("flash_attention_fwd: needs at least one key")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention_fwd: window ({window}) and "
                         f"q_offset ({q_offset}) must be >= 0")
    with _kernel("flash_attention_fwd", *flash_cost(
            q, k, v, causal, window, q_offset)):
        if _meta(q, k, v):
            B, Hq, Sq, _ = q.shape
            return (torch.empty((B, Hq, Sq, v.shape[3]), dtype=q.dtype,
                                device="meta"),
                    torch.empty((B, Hq, Sq), dtype=torch.float32,
                                device="meta"))
        if _all_on_cpu(q, k, v):
            return ref.flash_attention_fwd_ref(q, k, v, scale, causal,
                                               window, q_offset)
        return _flash_cuda(q, k, v, scale, causal, window, q_offset)


def _flash_cuda(q, k, v, scale, causal, window, q_offset):
    _check_codec("flash_attention_fwd",
                 **{n: (t, q.dtype) for n, t in (("q", q), ("k", k),
                                                 ("v", v))})
    B, Hq, Sq, Dh = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in _ATTN_DTYPES:
        raise TypeError(f"flash_attention_fwd: the CUDA kernel takes fp32 "
                        f"or bf16, got {q.dtype}")
    if Dh % 4 or not 4 <= Dh <= 192:
        raise ValueError(f"flash_attention_fwd: the CUDA kernel takes a "
                         f"query/key head dim that is a multiple of 4 up "
                         f"to 192, got {Dh}")
    if Dv % 4 or not 4 <= Dv <= min(Dh, 128):
        raise ValueError(f"flash_attention_fwd: the CUDA kernel takes a "
                         f"value head dim that is a multiple of 4 up to "
                         f"min(Dh, 128) = {min(Dh, 128)}, got {Dv}")
    if any(t.data_ptr() % (4 * t.element_size()) for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: q, k and v must be aligned "
                         "to 4 elements")
    o = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if B * Hq * Sq == 0:
        return o, lse
    _launch("flash_attention_fwd", "persia_flash_attention_fwd", q, o,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B, Hq, Hkv, Sq, Sk, Dh, Dv, float(scale),
             int(bool(causal)), int(window), int(q_offset),
             _ATTN_DTYPES[q.dtype]))
    _count(flash_attention_fwd)
    return o, lse


embedding_bag.launches = 0
unique_bag.launches = 0
fused_backward.launches = 0
blockscale_compress.launches = 0
blockscale_decompress.launches = 0
embedding_sgd.launches = 0
flash_attention_fwd.launches = 0
WRAPPERS = (embedding_bag, unique_bag, fused_backward, blockscale_compress,
            blockscale_decompress, embedding_sgd, flash_attention_fwd)


embedding_bag.tables = 0
unique_bag.tables = 0
blockscale_compress.tables = 0
blockscale_decompress.tables = 0
GROUPED = (embedding_bag, unique_bag, blockscale_compress,
           blockscale_decompress)


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


def table_counts() -> dict[str, int]:
    """Tables served by each function of the kernels that take a group of
    tables."""
    return {w.__name__: w.tables for w in GROUPED}


def reset_launch_counts() -> None:
    with _count_lock:
        for w in WRAPPERS:
            w.launches = 0
        for w in GROUPED:
            w.tables = 0
