"""The LM under a mesh: Megatron tensor parallelism over ``model`` and
ZeRO-3 over ``data``, by the partition rules (``sharding/partition.py``).

SPMD, as every mesh path of the port: each rank holds its block of every
dense leaf (``local_block`` of ``dense_param_specs`` after ``_guard``).
Before a block of layers runs, :func:`gather_params` all-gathers each of
its leaves over the axes of ``data`` it is sharded on (ZeRO-3; the
backward is the reduce-scatter of the gradient), which leaves every
weight in its tensor-parallel block: the column-parallel ``wq`` / ``wk``
/ ``wv`` / ``wg`` / ``wu`` / ``wuq`` / ``wuk`` / ``wuv`` / ``wq_b`` /
``lm_head`` keep their ``model`` block of output columns, the
row-parallel ``wo`` / ``wd`` / ``out_proj`` their block of input rows.
The layers find their own block from the weights' shapes (a weight as
wide as the config's is replicated), so the same layer code runs one
card, a mesh with replicated weights and a mesh with blocks.

The activations stay replicated over ``model``. A replicated tensor
enters split work through :func:`enter` (the identity forward, a sum over
``model`` backward) and split partial results leave through :func:`leave`
(a sum forward, the identity backward). A replicated parameter used
inside split work (a per-head norm) enters the same way, so its gradient
is the sum of every rank's part.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.utils import (_mesh_axis_names, axis_size, copy_to,
                               flat_index, gather_grad, get_mesh,
                               reduce_from)

MODEL = ("model",)


def n_model() -> int:
    """Ranks over ``model`` of the mesh in scope (1 without one)."""
    return axis_size(MODEL) if "model" in _mesh_axis_names() else 1


def model_index() -> int:
    return flat_index(MODEL) if "model" in _mesh_axis_names() else 0


def enter(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor into split work (Megatron's f)."""
    return copy_to(x, MODEL)


def leave(x: torch.Tensor) -> torch.Tensor:
    """Split work's partial results summed over ``model`` (Megatron's
    g)."""
    return reduce_from(x, MODEL)


def split(w: torch.Tensor, full: int, dim: int = -1) -> bool:
    """True where ``w``'s ``dim`` is a block of ``full`` (the weight is
    this rank's tensor-parallel block)."""
    return w.shape[dim] != full


def gather_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x``'s blocks along ``dim`` from every model rank, joined (the
    backward sums each block's gradient over the ranks that read it)."""
    return gather_grad(x, MODEL, dim)


# ---------------------------------------------------------------------------
# The spec of every dense leaf, and the ZeRO-3 gather
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _specs(cfg, shape: tuple, names: tuple, stage: int):
    from repro_torch.models import transformer as T
    from repro_torch.sharding import partition as SP
    from repro_torch.utils import MeshLayout
    layout = MeshLayout(shape, names)
    gen = torch.Generator()
    params = T.init_dense(cfg, gen, device=torch.device("meta"))
    raw = SP.dense_param_specs(params, stage)
    return SP._zip_map(lambda s, x: SP._fit(s, layout, x), raw, params)


def dense_specs(cfg, mesh=None, stage: int | None = None):
    """The spec of every dense leaf of ``cfg`` on ``mesh`` (the mesh in
    scope by default): ``dense_param_specs`` at ``stage`` (the ZeRO stage
    of ``REPRO_ZERO_STAGE`` by default), each fitted to the global shape
    (axes that do not divide a dim dropped)."""
    from repro_torch.sharding import partition as SP
    mesh = get_mesh() if mesh is None else mesh
    stage = SP.ZERO_STAGE if stage is None else stage
    return _specs(cfg, tuple(mesh.shape.values()), tuple(mesh.axis_names),
                  stage)


def unstacked(specs):
    """The specs of one layer of a tree of stacked leaves (each stack dim
    dropped)."""
    from repro_torch.sharding.partition import P, _zip_map
    return _zip_map(lambda s, _: P(*s[1:]), specs, specs)


def _data_axes(e) -> tuple:
    names = (e,) if isinstance(e, str) else tuple(e or ())
    return tuple(a for a in names if a != "model")


def gather_params(p, specs):
    """``p`` (a tree of this rank's blocks) with every leaf gathered over
    the ``data`` axes it is sharded on, by ``specs`` (the same tree of
    specs): each weight in its tensor-parallel block. ZeRO-3's gather;
    the backward reduce-scatters the gradient to the rank's block."""
    if specs is None:
        return p

    def one(x, spec):
        for dim, e in enumerate(spec):
            axes = _data_axes(e)
            if axes and axis_size(axes) > 1:
                x = gather_grad(x, axes, dim)
        return x
    from repro_torch.sharding.partition import _zip_map
    return _zip_map(lambda s, x: one(x, s), specs, p)


def sharded_axes(spec) -> tuple:
    """Every mesh axis a leaf of ``spec`` is sharded on."""
    out = []
    for e in spec:
        for a in ((e,) if isinstance(e, str) else tuple(e or ())):
            out.append(a)
    return tuple(out)
