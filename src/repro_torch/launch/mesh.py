"""Device meshes (the port of the reference's ``launch/mesh.py``).

Functions, never module constants: importing this module touches no
process group. A mesh is a ``torch.distributed`` ``DeviceMesh`` over the
default process group, which the caller starts first
(``torch.distributed.init_process_group`` with its own address, world
size and rank: nothing on the machine describes a cluster). The mesh
must cover the whole world: a world size other than the mesh's size
raises ValueError.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the default
    process group, ranks laid out row-major (the last axis varies
    fastest)."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ "
                         "in length")
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"world size {world} != mesh size "
                         f"{math.prod(shape)} of shape {shape}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16 x 16 = 256 devices ("data", "model"); 2 x 16 x 16 = 512 when
    ``multi_pod`` ("pod", "data", "model")."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return make_mesh((16, 16), ("data", "model"), device_type)


def make_host_mesh(data: int = 2, model: int = 2) -> DeviceMesh:
    """A small ("data", "model") mesh over CPU ranks (gloo), for tests."""
    return make_mesh((data, model), ("data", "model"), "cpu")
