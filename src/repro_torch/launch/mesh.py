"""Device meshes: ``torch.distributed.device_mesh.DeviceMesh`` over the
initialised world (``launch/multihost.py::initialize`` or
``torch.distributed.init_process_group``), one device a rank.

Functions, not module-level constants: importing this module touches no
process group. A CUDA mesh over a gloo world (several ranks on one card)
stages DTensor's collectives through the host
(``parallel/host_staging.py``). The reference's ``mesh_axis_kwargs`` has no counterpart: it
is a shim over JAX versions (``axis_types``), and a DeviceMesh has no axis
types.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mesh(shape: tuple, names: tuple, device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(launch/multihost.py::initialize)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {math.prod(shape)} ranks; "
                         f"the world has {world}")
    if device_type == "cuda" and dist.get_backend() == "gloo":
        # several ranks on one card: gloo carries CUDA tensors only in part
        from ..parallel import host_staging

        host_staging.install()
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The reference's production shapes: ("data", "model") 16 x 16, and a
    leading "pod" axis of 2 with ``multi_pod``; the world must have 256 or
    512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over the world's data x model ranks."""
    return _mesh((data, model), ("data", "model"), device_type)
