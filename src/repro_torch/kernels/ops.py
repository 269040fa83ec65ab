"""Public wrappers around the port's CUDA kernels (the counterpart of
``repro/kernels/ops.py``).

Tensors that lie on the CPU go to the plain torch version in ``ref``; that
is the only way to it. Tensors on a CUDA device launch the kernel on the
current stream, or raise: wrong device mix, dtype, shape or layout is an
error, never a quiet detour through the plain version.

Each wrapper counts its launches in ``<wrapper>.launches`` (a plain int,
raised by one per kernel launch and nowhere else), so a caller can show
that a run went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "persia_embedding_bag_f32": (_P, _P, _P, _I64, _I, _I, _I, _P),
    "persia_unique_bag_f32": (_P, _P, _P, _P, _I64, _I, _I, _I, _I, _P),
}
_fns: dict = {}


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("bag"), name)
        fn.argtypes = list(_SIGNATURES[name])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _all_on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_cuda(op: str, table: torch.Tensor, **index: torch.Tensor):
    """The CUDA kernels take an fp32 contiguous (V, D) table and int32
    contiguous index arrays, all on one CUDA device."""
    devices = {t.device for t in (table, *index.values())}
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


def embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(V, D) x (B, L) ids (< 0 = padding) -> (B, D) fused gather and sum
    pool. Port of ``repro.kernels.ops.embedding_bag``."""
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
    _launch("embedding_bag", "persia_embedding_bag_f32", table, out,
            (table.data_ptr(), ids.data_ptr(), out.data_ptr(), V, B, L, D))
    embedding_bag.launches += 1
    return out


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
    unique_bag.launches += 1
    return out


embedding_bag.launches = 0
unique_bag.launches = 0
WRAPPERS = (embedding_bag, unique_bag)


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
