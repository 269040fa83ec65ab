"""Small shared helpers: integer arithmetic (copied from ``repro/utils.py``),
the nested dict/list walks that stand in for ``jax.tree``, and the mesh in
scope with the collectives of its axes (``repro/utils.py``'s sharding
helpers, on ``torch.distributed``)."""
from __future__ import annotations

import contextlib
import math
import threading
import warnings


def default_field_rows(total_rows: int, n_fields: int) -> int:
    """Rows of each field's id space when one flat row budget is split
    evenly over fields — the single source of the formula shared by
    CTRDataset (id generation) and ctr_collection (table sizing)."""
    return max(total_rows // max(n_fields, 1), 4)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over nested dicts and lists of the same
    structure (the parameter trees of the dense model and its optimizer).
    ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict/list tree, dict keys in sorted order (the
    order of ``jax.tree.leaves``, so sums over leaves add alike)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


# ---------------------------------------------------------------------------
# The mesh in scope (the JAX package's ``jax.sharding.set_mesh`` and the
# helpers of ``repro/utils.py`` that read it)
# ---------------------------------------------------------------------------
#
# JAX runs one controller over global arrays, and a ``shard_map`` body sees
# one device's block. The port is SPMD instead: one process per mesh
# position, and under a mesh every mesh-aware function takes and returns the
# rank's block, the block that the ``shard_map`` body sees. The collectives
# of the bodies run over the mesh's process groups: ``psum`` is an
# ``all_reduce`` (SUM), ``pmax`` one with MAX, a tiled ``all_gather`` is
# ``all_gather_into_tensor``, ``all_to_all`` is ``all_to_all_single`` and
# ``axis_index`` is the rank's coordinate on the axis.

class MeshLayout:
    """A mesh's shape, without process groups: ``shape`` {axis: size} in
    axis order, the row-major rank layout of ``jax.make_mesh``. A rank's
    coordinates and flat indices over a subset of axes follow from it, so
    host code can cut and join the blocks of every rank
    (``sharding.local_block`` / ``from_blocks``)."""

    def __init__(self, shape, axis_names):
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} "
                             "do not match")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.n_ranks = math.prod(shape)

    def axes(self, axes) -> tuple:
        """A name or a tuple of names -> the tuple of them in mesh order
        (unknown names dropped, as the JAX package drops them)."""
        want = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return tuple(a for a in self.axis_names if a in want)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def coords(self, rank: int) -> dict:
        out, r = {}, int(rank)
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def flat_index(self, axes, rank: int) -> int:
        """The rank's row-major index over ``axes`` (JAX's ``_flat_index``
        of the ``axis_index`` values)."""
        c, idx = self.coords(rank), 0
        for a in self.axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx


class Mesh(MeshLayout):
    """An SPMD device mesh over ``torch.distributed``: the world's ranks laid
    out row-major over ``shape`` (as ``jax.make_mesh`` lays out devices),
    with a process group for every subset of the axes (the ranks that share
    the other axes' coordinates, in flat-index order), so a collective over
    ``("pod", "data")`` or over every axis is one call. It stands in for
    ``DeviceMesh`` (``get_group``, ``get_coordinate``, ``device_type``
    name the same things); the port builds its own groups because the
    paths reduce over several axes at once and the pipelined trainer needs
    a second set of groups for each stage thread (:meth:`fork`).

    Creating a mesh is collective: every rank of the default process group
    creates the same groups in the same order. ``device_type`` is
    ``"cuda"`` (the rank's current device) unless the caller asks for
    ``"cpu"``; the collectives run on the default group's backend (gloo
    carries CPU and CUDA tensors, NCCL CUDA ones)."""

    def __init__(self, shape, axis_names, device_type: str = "cuda"):
        import torch
        import torch.distributed as dist
        super().__init__(shape, axis_names)
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs torch.distributed initialised "
                               "(init_process_group) first")
        if dist.get_world_size() != self.n_ranks:
            raise ValueError(
                f"mesh {self.shape} has {self.n_ranks} positions but the world "
                f"has {dist.get_world_size()} ranks")
        if device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        elif device_type == "cpu":
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"unsupported mesh device {device_type!r}")
        self.device_type = device_type
        self.rank = dist.get_rank()
        self._coords = self.coords(self.rank)
        self._groups = {}
        names = self.axis_names
        for mask in range(1, 1 << len(names)):
            sub = tuple(a for i, a in enumerate(names) if mask >> i & 1)
            fibers: dict = {}
            for r in range(self.n_ranks):
                c = self.coords(r)
                key = tuple(c[a] for a in names if a not in sub)
                fibers.setdefault(key, []).append(r)
            mine = tuple(self._coords[a] for a in names if a not in sub)
            for key in sorted(fibers):
                g = dist.new_group(fibers[key])
                if key == mine:
                    self._groups[sub] = g

    def fork(self) -> "Mesh":
        """A mesh of the same layout with groups of its own (collective):
        threads that run collectives concurrently each use one, so no two
        threads' calls interleave on one group."""
        return Mesh(tuple(self.shape.values()), self.axis_names,
                    self.device_type)

    def get_group(self, axes):
        return self._groups[self.axes(axes)]

    def get_coordinate(self) -> list:
        return [self._coords[a] for a in self.axis_names]

    def index(self, axes) -> int:
        """This rank's flat index over ``axes`` (``axis_index`` of one
        axis, JAX's ``_flat_index`` of several)."""
        return self.flat_index(axes, self.rank)


_MESH = {"mesh": None}
_THREAD = threading.local()


@contextlib.contextmanager
def set_mesh(mesh):
    """``with set_mesh(mesh):`` puts ``mesh`` in scope for every thread of
    the process (``jax.sharding.set_mesh``; the pipelined trainer's stage
    threads see it) and restores the previous one on exit. ``None`` takes
    the mesh out of scope."""
    prev = _MESH["mesh"]
    _MESH["mesh"] = mesh
    try:
        yield mesh
    finally:
        _MESH["mesh"] = prev


@contextlib.contextmanager
def use_groups(mesh):
    """In this thread only, run the collectives over ``mesh``'s groups (a
    :meth:`Mesh.fork` of the mesh in scope): the pipelined trainer gives
    each stage thread its own."""
    prev = getattr(_THREAD, "mesh", None)
    _THREAD.mesh = mesh
    try:
        yield mesh
    finally:
        _THREAD.mesh = prev


def get_mesh():
    """The mesh in scope (this thread's :func:`use_groups` fork of it, if
    any), or ``None``."""
    mine = getattr(_THREAD, "mesh", None)
    return mine if mine is not None else _MESH["mesh"]


def _mesh_axis_names() -> tuple[str, ...]:
    mesh = get_mesh()
    return () if mesh is None else tuple(mesh.axis_names)


def shard(x, *spec):
    """The identity: the JAX package's sharding constraint is a hint to its
    compiler, and the port places every block explicitly."""
    return x


def batch_axes() -> tuple[str, ...]:
    """Mesh axes over which the batch is sharded ('pod' first when
    present)."""
    names = _mesh_axis_names()
    return tuple(n for n in ("pod", "data") if n in names)


def axis_size(axes) -> int:
    """The number of ranks over ``axes`` of the mesh in scope (1 without a
    mesh, or for axes it lacks)."""
    mesh = get_mesh()
    return 1 if mesh is None else mesh.axis_size(axes)


def n_batch_shards() -> int:
    return axis_size(batch_axes())


def bspec_axes(dim_size: int):
    """Batch axes tuple if dim_size divides over them, else None
    (replicate). Handles B=1 decode shapes on many-shard meshes."""
    axes = batch_axes()
    if not axes or dim_size % n_batch_shards() != 0:
        return None
    return axes


def flat_index(axes) -> int:
    """This rank's row-major index over ``axes`` of the mesh in scope (0
    without a mesh)."""
    mesh = get_mesh()
    return 0 if mesh is None else mesh.index(axes)


def _group(axes):
    """The group over ``axes`` of the mesh in scope, or ``None`` where the
    collective is the identity (no mesh, no such axes, or one rank)."""
    mesh = get_mesh()
    if mesh is None or mesh.axis_size(axes) == 1:
        return None
    return mesh.get_group(axes)


# Every collective goes through :func:`_collective`, which counts each call
# and the bytes of its result by the collective's name in the JAX package's
# HLO (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``):
# ``collective_counts()`` for a run on ranks, and the recorders that
# ``launch.op_cost`` opens for a dry run, which reads the same numbers.

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_COUNTS: dict = {}
_RECORDERS: list = []
_COUNT_LOCK = threading.Lock()


def _collective(kind: str, run, result):
    """Runs ``run()`` (the ``torch.distributed`` call that writes
    ``result``), counts it under ``kind`` with ``result``'s bytes, tells the
    open recorders, and returns ``result``. The tensor ops a backend needs
    to carry it (the reduce-scatter's all-reduce and slice) are part of the
    collective: ``launch.op_cost`` does not count them as kernels."""
    from repro_torch.launch.op_cost import suspended
    with suspended():
        run()
    nbytes = result.numel() * result.element_size()
    with _COUNT_LOCK:
        c = _COUNTS.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += nbytes
        recorders = list(_RECORDERS)
    for rec in recorders:
        rec(kind, nbytes)
    return result


def collective_counts() -> dict:
    """{kind: {"calls", "bytes"}} of the collectives since the last
    :func:`reset_collective_counts` (result bytes, each call once)."""
    with _COUNT_LOCK:
        return {k: {"calls": c[0], "bytes": c[1]}
                for k, c in sorted(_COUNTS.items())}


def reset_collective_counts() -> None:
    with _COUNT_LOCK:
        _COUNTS.clear()


@contextlib.contextmanager
def record_collectives(fn):
    """Calls ``fn(kind, result_bytes)`` for every collective of this
    process while open (``launch.op_cost``)."""
    with _COUNT_LOCK:
        _RECORDERS.append(fn)
    try:
        yield fn
    finally:
        with _COUNT_LOCK:
            _RECORDERS.remove(fn)


def psum(x, axes):
    """``jax.lax.psum`` over ``axes``: the sum over their ranks, in place
    on ``x`` (contiguous), returned. No backward: see :func:`reduce_from`
    and :func:`copy_to` for the differentiable pair."""
    import torch.distributed as dist
    g = _group(axes)
    if g is None:
        return x
    return _collective("all-reduce", lambda: dist.all_reduce(
        x, op=dist.ReduceOp.SUM, group=g), x)


def pmax(x, axes):
    """``jax.lax.pmax`` over ``axes``, in place on ``x``, returned."""
    import torch.distributed as dist
    g = _group(axes)
    if g is None:
        return x
    return _collective("all-reduce", lambda: dist.all_reduce(
        x, op=dist.ReduceOp.MAX, group=g), x)


def all_gather(x, axes):
    """``jax.lax.all_gather(x, axes, tiled=True)``: the ranks' blocks
    concatenated along dim 0 in flat-index order (each rank's ``x`` of one
    shape)."""
    import torch
    import torch.distributed as dist
    g = _group(axes)
    if g is None:
        return x
    x = x.contiguous()
    out = torch.empty((axis_size(axes) * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)

    def run():
        with warnings.catch_warnings():
            # newer torch renames it all_gather_single; the name stays valid
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, x, group=g)
    return _collective("all-gather", run, out)


def reduce_scatter(x, axes):
    """``jax.lax.psum_scatter(x, axes, tiled=True)``: the sum over the
    ranks of ``axes`` of (n * m, ...) ``x``, of which this rank keeps rows
    [i * m, (i + 1) * m), i its flat index."""
    import torch
    import torch.distributed as dist
    g = _group(axes)
    if g is None:
        return x
    x = x.contiguous()
    out = torch.empty((x.shape[0] // axis_size(axes), *x.shape[1:]),
                      dtype=x.dtype, device=x.device)

    def run():
        with warnings.catch_warnings():
            # newer torch renames it reduce_scatter_single
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, x, group=g)
    return _collective("reduce-scatter", run, out)


def all_to_all(x, axes):
    """``jax.lax.all_to_all(x, axes, 0, 0, tiled=False)`` for (n, ...) ``x``
    with n the ranks over ``axes``: row j goes to rank j, and row j of the
    result came from rank j."""
    import torch
    import torch.distributed as dist
    g = _group(axes)
    if g is None:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    return _collective("all-to-all", lambda: dist.all_to_all_single(
        out, x, group=g), out)


# ---------------------------------------------------------------------------
# Collectives that autograd passes through (Megatron's f / g, ZeRO-3's
# gather). Each is the identity where its axes have one rank.
# ---------------------------------------------------------------------------

def _functions():
    import torch

    class CopyTo(torch.autograd.Function):
        """Megatron's f: the identity forward, a sum over ``axes``
        backward (a replicated input of work split over the ranks)."""

        @staticmethod
        def forward(ctx, x, axes):
            ctx.axes = axes
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return psum(g.contiguous().clone(), ctx.axes), None

    class ReduceFrom(torch.autograd.Function):
        """Megatron's g: a sum over ``axes`` forward, the identity
        backward (the partial results of work split over the ranks)."""

        @staticmethod
        def forward(ctx, x, axes):
            return psum(x.contiguous().clone(), axes)

        @staticmethod
        def backward(ctx, g):
            return g, None

    class GatherScatter(torch.autograd.Function):
        """An all-gather along ``dim`` forward, a reduce-scatter (sum)
        along it backward: a ZeRO-3 weight, or a column block every rank
        reads."""

        @staticmethod
        def forward(ctx, x, axes, dim):
            ctx.axes, ctx.dim = axes, dim
            return _gather_dim(x, axes, dim)

        @staticmethod
        def backward(ctx, g):
            return _scatter_dim(g, ctx.axes, ctx.dim), None, None

    class AllToAll(torch.autograd.Function):
        """:func:`all_to_all` forward, the reversed all-to-all backward
        (row j of the gradient goes back to rank j)."""

        @staticmethod
        def forward(ctx, x, axes):
            ctx.axes = axes
            return all_to_all(x, axes)

        @staticmethod
        def backward(ctx, g):
            return all_to_all(g, ctx.axes), None

    class GatherSplit(torch.autograd.Function):
        """An all-gather along ``dim`` forward, this rank's block of the
        gradient backward: disjoint pieces joined into a tensor every rank
        then holds alike (a replicated activation, whose gradient every
        rank holds alike)."""

        @staticmethod
        def forward(ctx, x, axes, dim):
            ctx.axes, ctx.dim, ctx.size = axes, dim, x.shape[dim]
            return _gather_dim(x, axes, dim)

        @staticmethod
        def backward(ctx, g):
            i = flat_index(ctx.axes)
            return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None

    return CopyTo, ReduceFrom, GatherScatter, AllToAll, GatherSplit


_FUNCTIONS: list = []


def _fn(i: int):
    if not _FUNCTIONS:
        _FUNCTIONS.extend(_functions())
    return _FUNCTIONS[i]


def _gather_dim(x, axes, dim: int):
    if _group(axes) is None:
        return x
    d = dim % x.dim()
    y = all_gather(x.movedim(d, 0), axes)
    return y.movedim(0, d)


def _scatter_dim(x, axes, dim: int):
    if _group(axes) is None:
        return x
    d = dim % x.dim()
    y = reduce_scatter(x.movedim(d, 0), axes)
    return y.movedim(0, d)


def copy_to(x, axes):
    """Identity forward, sum over ``axes`` backward (Megatron's f)."""
    return x if _group(axes) is None else _fn(0).apply(x, axes)


def reduce_from(x, axes):
    """Sum over ``axes`` forward, identity backward (Megatron's g)."""
    return x if _group(axes) is None else _fn(1).apply(x, axes)


def gather_grad(x, axes, dim: int = 0):
    """All-gather along ``dim`` over ``axes``, reduce-scatter backward."""
    return x if _group(axes) is None else _fn(2).apply(x, axes, dim)


def all_to_all_grad(x, axes):
    """:func:`all_to_all` with the reversed all-to-all as its backward."""
    return x if _group(axes) is None else _fn(3).apply(x, axes)


def gather_split(x, axes, dim: int = 0):
    """All-gather along ``dim`` over ``axes``; the backward keeps this
    rank's block of the gradient."""
    return x if _group(axes) is None else _fn(4).apply(x, axes, dim)


def gather_batch(x):
    """The global batch from every rank's batch block (``x`` sharded over
    the batch axes along dim 0), on every rank; ``x`` itself without a
    mesh."""
    return all_gather(x, batch_axes())


def from_rank0(obj):
    """Rank 0's ``obj`` (any picklable value) on every rank of the mesh in
    scope; every rank waits until rank 0 sends it, so it doubles as a
    barrier that carries rank 0's outcome. ``obj`` itself without a mesh
    of more than one rank."""
    import torch.distributed as dist
    mesh = get_mesh()
    if mesh is None or mesh.n_ranks == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0,
                               group=mesh.get_group(mesh.axis_names))
    return box[0]
