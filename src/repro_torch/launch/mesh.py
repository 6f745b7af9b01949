"""Mesh shapes (``repro.launch.mesh``'s port).

``repro`` builds its meshes over TPU chips. The port separates the two
halves of a mesh: :class:`MeshShape` is the axis names and sizes alone
(``jax.sharding.AbstractMesh``'s role: no devices, what the spec rules of
``dist.sharding`` read), and :func:`device_mesh` lays a shape onto the
ranks of an initialised process group as a
``torch.distributed.device_mesh.DeviceMesh``. Single pod: (data=16,
model=16) = 256 chips. Multi-pod: (pod=2, data=16, model=16) = 512; the
pod axis joins the worker axis of the robust aggregation and shards the
batch.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

__all__ = ["MeshShape", "make_production_mesh", "make_host_mesh",
           "device_mesh"]


class MeshShape(NamedTuple):
    """Axis names and sizes of a mesh, no devices: ``.shape[name]`` and
    ``.axis_names`` as a ``jax.sharding.Mesh`` answers them."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def _mesh(sizes, names) -> MeshShape:
    if len(sizes) != len(names):
        raise ValueError(f"{len(sizes)} sizes for the axes {names}")
    return MeshShape(tuple(names), tuple(int(s) for s in sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(data: int = 4, model: int = 2, pod: int = 1) -> MeshShape:
    """A small mesh (``repro``'s host-device test mesh)."""
    if pod > 1:
        return _mesh((pod, data, model), ("pod", "data", "model"))
    return _mesh((data, model), ("data", "model"))


def device_mesh(shape: MeshShape, device_type: str = "cuda"):
    """``shape`` laid onto the ranks of the initialised default process
    group, row-major (``init_device_mesh``). Raises when no group is
    initialised, or when its world size is not the mesh's size."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "device_mesh needs an initialised torch.distributed process "
            "group (init_process_group, or torchrun)")
    if dist.get_world_size() != shape.size:
        raise ValueError(f"mesh {dict(shape.shape)} has {shape.size} "
                         f"devices; the group has {dist.get_world_size()} "
                         f"ranks")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape.sizes,
                            mesh_dim_names=shape.axis_names)
