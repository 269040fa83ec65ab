"""Mesh builders (port of ``repro/launch/mesh.py``).

Single pod: (data=16, model=16), 256 ranks. Multi-pod: (pod=2, data=16,
model=16), 512 ranks; the 'pod' axis only carries batch parallelism (the
gradient sum crosses pods once a step), while the model axis stays inside
a pod.

Functions, not module-level constants: importing this module creates no
process group. Each builder needs ``torch.distributed`` initialised with
a world of exactly the mesh's size (one process per mesh position) and
raises otherwise.
"""
from __future__ import annotations

from repro_torch.utils import Mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda") -> Mesh:
    """Degenerate 1x1 mesh: the sharded code paths in a world of one."""
    return Mesh((1, 1), ("data", "model"), device_type)


def mesh_batch_shards(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def mesh_model_shards(mesh) -> int:
    return mesh.shape.get("model", 1)


def mesh_all_shards(mesh) -> int:
    n = 1
    for a in mesh.axis_names:
        n *= mesh.shape[a]
    return n
