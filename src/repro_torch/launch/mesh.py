"""Production mesh construction.

Counterpart of ``repro.launch.mesh``. The meshes are ``DeviceMesh``es over
the initialised process group, one rank per device; they are built by
functions (no module-level constant), so importing this module touches no
device and no process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _mesh(shape, axes, device_type: str):
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh {axes} needs {need} ranks; "
            f"this world has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 = 256 devices per pod; 2 pods = 512 devices for multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device_type: str = "cuda"):
    """A small mesh (the tests run it in gloo groups of CPU processes)."""
    return _mesh(shape, axes, device_type)
