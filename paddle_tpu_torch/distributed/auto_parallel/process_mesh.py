"""ProcessMesh: the cartesian process topology (counterpart of
paddle_tpu/distributed/auto_parallel/process_mesh.py).

A ProcessMesh names world ranks in an n-d array with a name a dimension.
It is backed lazily by a ``torch.distributed.DeviceMesh`` over the same
ranks (``device_mesh()``), as the reference backs it lazily by a JAX mesh.
The device type follows the world: "cuda" for NCCL and for gloo ranks on
the card, "cpu" for a CPU gloo world. Building the DeviceMesh makes one
process group a mesh dimension, a collective: every rank of the world
builds the meshes it uses in one order (shard_layer, shard_tensor and
reshard do it at first use). Equal meshes share one DeviceMesh.

The reference wraps process ids modulo the device count (its single
controller reuses devices); here a process id is a rank, and a mesh that
names a rank outside the world raises ValueError.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ProcessMesh", "get_current_mesh"]

_mesh_stack: list = []
# (mesh bytes, shape, dim names, device type) -> (world group, DeviceMesh)
_DEVICE_MESHES: dict = {}


class ProcessMesh:
    def __init__(self, mesh, dim_names=None, shape=None, process_ids=None):
        if mesh is None and shape is not None:
            mesh = np.asarray(process_ids, dtype=np.int64).reshape(shape)
        self._mesh = np.asarray(mesh, dtype=np.int64)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(self._mesh.ndim)]
        assert len(dim_names) == self._mesh.ndim
        self._dim_names = list(dim_names)

    # -- reference API surface --------------------------------------------
    @property
    def mesh(self):
        return self._mesh

    @property
    def shape(self):
        return list(self._mesh.shape)

    @property
    def ndim(self):
        return self._mesh.ndim

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def process_ids(self):
        return self._mesh.flatten().tolist()

    def get_dim_size(self, dim_name):
        return self._mesh.shape[self._dim_names.index(dim_name)]

    def get_rank_by_dim_and_process_id(self, dim_name, process_id):
        axis = self._dim_names.index(dim_name)
        loc = np.argwhere(self._mesh == process_id)
        return int(loc[0][axis]) if len(loc) else -1

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and np.array_equal(self._mesh, other._mesh)
                and self._dim_names == other._dim_names)

    def __hash__(self):
        return hash((self._mesh.tobytes(), tuple(self._dim_names)))

    def __repr__(self):
        return (f"ProcessMesh(shape={self.shape}, "
                f"dim_names={self._dim_names})")

    def __enter__(self):
        _mesh_stack.append(self)
        return self

    def __exit__(self, *exc):
        _mesh_stack.pop()

    # -- torch backing -----------------------------------------------------
    def device_mesh(self):
        """The DeviceMesh over these ranks (built at first use, a
        collective of the world)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from ..env import world_device_type
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs the world: call "
                               "distributed.init_parallel_env() first")
        world = dist.get_world_size()
        if self._mesh.size and (self._mesh.min() < 0
                                or self._mesh.max() >= world):
            raise ValueError(
                f"ProcessMesh {self._mesh.tolist()} names ranks outside the "
                f"world of {world} (the port does not wrap process ids "
                f"modulo the device count)")
        dev = world_device_type()
        key = (self._mesh.tobytes(), self._mesh.shape,
               tuple(self._dim_names), dev)
        pg = dist.group.WORLD
        hit = _DEVICE_MESHES.get(key)
        if hit is None or hit[0] is not pg:
            hit = (pg, DeviceMesh(dev, self._mesh.tolist(),
                                  mesh_dim_names=tuple(self._dim_names)))
            _DEVICE_MESHES[key] = hit
        return hit[1]


def get_current_mesh():
    return _mesh_stack[-1] if _mesh_stack else None
