"""Production mesh construction: the counterpart of ``repro/launch/mesh.py``.

Functions, not module-level constants, so importing this module never
touches a process group; the dry-run sets up its fake group of 256 or 512
ranks before calling them.  Both build a ``DeviceMesh`` over the process
group that is already initialised and raise, as ``jax.make_mesh`` does,
when its world size is not the mesh's size.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str) -> DeviceMesh:
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {need} ranks; the process group "
            f"has {world}" + ("" if dist.is_initialized() else " (none is initialised)")
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The pod mesh of 256 ranks: (data=16, model=16); two pods (512 ranks)
    add a 'pod' DP axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 2, model: int = 2, *, device_type: str = "cpu") -> DeviceMesh:
    """Small mesh for correctness tests (gloo or the fake process group)."""
    return _make_mesh((data, model), ("data", "model"), device_type)


def world_mesh(device_type: str) -> DeviceMesh | None:
    """The drivers' mesh without ``--production``: (n, 1) over ("data",
    "model") in an initialised process group of n > 1 ranks, as the JAX
    drivers' ``(len(jax.devices()), 1)``; None at one rank, where a
    one-device mesh would shard nothing."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n == 1:
        return None
    return init_device_mesh(device_type, (n, 1), mesh_dim_names=("data", "model"))
