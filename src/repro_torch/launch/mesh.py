"""Mesh construction (port of `repro.launch.mesh`).

Functions, so importing this module never touches a process group.  A
mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims; a
production mesh without a process group of its size is its `MeshShape`
(axis names and sizes, no devices), which is all
`distributed.ShardingRules` needs.
"""
from __future__ import annotations

import math

from repro_torch.distributed.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 single pod (256 devices) or 2x16x16 multi-pod (512): a
    `DeviceMesh` when a process group of that size exists, else its
    `MeshShape`.  DP spans ("pod", "data"); TP spans "model"."""
    import torch.distributed as dist

    shape = MeshShape(("pod", "data", "model"), (2, 16, 16)) if multi_pod \
        else MeshShape(("data", "model"), (16, 16))
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape.sizes):
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(device_type, shape.sizes, mesh_dim_names=shape.axis_names)
    return shape


def make_test_mesh(dp: int = 2, tp: int = 4, device_type: str = "cuda"):
    """A (dp, tp) mesh with dims ("data", "model") over the current
    process group (dp * tp ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("data", "model"))
