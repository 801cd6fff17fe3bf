"""Meshes: named axes over the ranks of a ``torch.distributed`` world.

The JAX package's ``launch/mesh.py`` on PyTorch.  A :class:`Mesh` holds
its axis sizes by name (``mesh.shape["data"]``, ``mesh.axis_names``),
which is all the sharding rules read.  In an initialized world it also
holds a ``DeviceMesh`` over the world's ranks and one process group per
axis, which the collectives of ``analytics.distributed``,
``train.compression`` and the trainer reduce over.  Outside one (a
process with no process group) a mesh must have size 1, and those
collectives are then the identity on the one rank's data.

Production shapes, as in the JAX package:

* single-pod: (16, 16), axes (data, model);
* multi-pod:  (2, 16, 16), axes (pod, data, model).

They build only in a world of that size (``launch/dryrun.py`` builds
them in a ``"fake"`` world).  Activations are placed over a mesh by
``models/shard_ctx.py``, the JAX package's module of that name.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist


class Mesh:
    """Axis sizes by name over the ranks of the world (row-major)."""

    def __init__(self, shape, axes):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             f"pair up one to one")
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        self.size = math.prod(shape)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.size != world:
            raise ValueError(f"a mesh of {self.size} ranks {self.shape} "
                             f"needs a world of {self.size} ranks; this "
                             f"process's world has {world}")
        self.device_mesh = None
        if dist.is_initialized():
            from torch.distributed.device_mesh import DeviceMesh
            kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
            self.device_mesh = DeviceMesh(
                kind, torch.arange(self.size).reshape(shape),
                mesh_dim_names=axes)

    def group(self, axis: str) -> Optional["dist.ProcessGroup"]:
        """The process group of this rank's line along ``axis``; None
        outside an initialized world."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)


def make_mesh(shape, axes) -> Mesh:
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_smoke_mesh(n_devices: int = 1) -> Mesh:
    """(1, n) over (data, model): the JAX package's test mesh."""
    return make_mesh((1, n_devices), ("data", "model"))


def world_mesh() -> Mesh:
    """Every rank of the world on one ``data`` axis (one rank outside an
    initialized world): data parallelism over the world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((world,), ("data",))
