"""Per-device cost of one call, counted op by op (the port's stand-in for
``repro/launch/hlo_cost.py``, which walks the post-SPMD HLO text of a
compiled XLA program: the port has no HLO).

``analyze(fn, *args)`` runs ``fn`` under a ``TorchDispatchMode`` and
returns the JAX walker's keys, per device (one process is one rank):

  * ``flops``       -- 2*M*N*K for every matmul-class op (``mm``,
                       ``addmm``, ``bmm``, ``baddbmm``);
  * ``hbm_bytes``   -- the operand and result bytes of every op that is
                       not a view (the roofline accounting of one op = one
                       kernel);
  * one entry per name in ``COLLECTIVES`` -- the bytes of each
    collective's result, an all-reduce counted twice (a ring moves about
    twice its size), as ``hlo_cost`` counts them; ``collective_total``
    their sum and ``counts`` the calls by name.

Each hand-written kernel wrapper of ``kernels/ops.py`` counts as ONE
kernel with the FLOPs and bytes of its own formula (the bounds
``chip_smoke.py`` uses), and the plain ops inside it (its plain version
on the CPU) are not counted: ``hlo_cost``'s "one fusion == one kernel".
So a CPU run, a run on the ``meta`` device (the dry run) and a run on the
card count the same numbers. The collectives are counted where they are
called (``utils._collective``), whatever carries them.

It also follows the bytes of the tensors the ops make while ``fn`` runs
(freed when the tensor is): ``temp_peak_bytes`` is their peak. On the
``meta`` device that is the live-bytes count of the dry run's
``temp_bytes_per_device``; it does not see the caching allocator's
rounding or fragmentation.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.utils import COLLECTIVES, record_collectives

_MATMUL = {"mm", "addmm", "bmm", "baddbmm"}
# ops whose results share their input's storage and move no bytes
_FREE = {"detach", "alias", "lift_fresh", "_unsafe_view", "view",
         "_reshape_alias", "expand", "t", "transpose", "permute",
         "unsqueeze", "squeeze", "slice", "select", "split", "unbind",
         "narrow", "as_strided", "view_as", "split_with_sizes", "chunk",
         "diagonal", "movedim", "unflatten", "expand_as", "_fw_primal",
         "_make_dual", "_unwrap_for_grad", "set_", "resize_", "empty",
         "empty_like", "new_empty", "empty_strided", "new_empty_strided",
         "_pin_memory", "pin_memory", "is_pinned"}
_MOVES = {"_to_copy", "copy_", "to"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _mm_flops(name: str, args, out) -> float:
    if name in ("mm", "bmm"):
        a, b = args[0], args[1]
    else:                                      # addmm / baddbmm: (c, a, b)
        a, b = args[1], args[2]
    return 2.0 * out.numel() * a.shape[-1] if out is not None else 0.0


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm = 0.0
        self.coll = defaultdict(float)
        self.counts = defaultdict(float)
        self.kernels = defaultdict(float)
        self.by_op = defaultdict(float)
        self.live = 0
        self.peak = 0
        self.suspended = 0

    # kernels/ops.py's wrappers report here (ops.kernel_cost)
    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.hbm += nbytes
        self.kernels[name] += 1

    def collective(self, kind: str, nbytes: int) -> None:
        self.coll[kind] += nbytes * (2.0 if kind == "all-reduce" else 1.0)
        self.counts[kind] += 1

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.suspended or func.namespace != "aten":
            return out
        name = func._schema.name.split("::")[-1]
        if name in _FREE or getattr(func, "is_view", False):
            return out
        res = list(_tensors(out))
        ins = list(_tensors((args, kwargs)))
        if name in _MOVES and len({t.device for t in ins + res}) > 1:
            return out                  # a host-device copy, not a kernel
        if name in _MATMUL:
            self.flops += _mm_flops(name, args, res[0] if res else None)
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in res)
        self.hbm += nbytes
        self.by_op[name] += nbytes
        inputs = {id(t) for t in ins}
        for t in res:
            if id(t) in inputs:                   # an in-place op's result
                continue
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)
        return out


_ACTIVE: list = []


def active():
    """The counter of the :func:`analyze` running, or None (what the
    kernel wrappers report to; a backward may run on autograd's device
    thread, so it is the process's)."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def suspended():
    """No op counted while open: a kernel wrapper's own plain ops."""
    c = active()
    if c is None:
        yield
        return
    c.suspended += 1
    try:
        yield
    finally:
        c.suspended -= 1


def analyze(fn, *args, **kwargs) -> dict:
    """Runs ``fn(*args, **kwargs)`` once and returns ``(result, cost)``,
    ``cost`` the module docstring's keys."""
    c = _Counter()
    _ACTIVE.append(c)
    try:
        with record_collectives(c.collective), c:
            result = fn(*args, **kwargs)
    finally:
        _ACTIVE.remove(c)
    cost = {"flops": c.flops, "hbm_bytes": c.hbm,
            **{k: c.coll.get(k, 0.0) for k in COLLECTIVES}}
    cost["collective_total"] = sum(cost[k] for k in COLLECTIVES)
    cost["counts"] = {k: v for k, v in sorted(c.counts.items())}
    cost["kernels"] = dict(sorted(c.kernels.items()))
    cost["temp_peak_bytes"] = c.peak
    cost["hbm_bytes_by_op"] = dict(sorted(c.by_op.items()))
    return result, cost
