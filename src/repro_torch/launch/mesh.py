"""Device meshes over the initialized process group.

Torch counterpart of ``repro.launch.mesh``.  Functions, not module-level
state: importing this module touches no process group.  Each builds a
``torch.distributed.device_mesh.DeviceMesh`` with dim names over the
ranks of the process group the caller has initialized
(``torch.distributed.init_process_group``), one rank a device, on CUDA
unless the caller names another device type (the CPU tests: ``"cpu"``
with the gloo backend).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch.distributed as dist


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
          device_type: Optional[str]):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The reference's target mesh: (16, 16) data x model over 256 ranks,
    or (2, 16, 16) pod x data x model over 512 with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1,
                    device_type: Optional[str] = None):
    """A (data, model) mesh over the current world of data x model
    ranks."""
    return _mesh((data, model), ("data", "model"), device_type)
