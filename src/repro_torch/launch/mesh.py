"""Production and host meshes for the sharded LM.

Port of ``repro.launch.mesh``.  FUNCTIONS over an initialised process
group, not module-level constants: importing this module touches no
device and no process group.  ``device=None`` is the CUDA card (and raises
without one); the dry run and the CPU tests pass ``"cpu"``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device

__all__ = ["make_host_mesh", "make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) with ``pod`` first:
    256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> DeviceMesh:
    """A small ``("data", "model")`` mesh over the first ranks of the group,
    its sizes clamped to the world size as the reference clamps them to
    its devices."""
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(1, n // data))
    return _mesh((data, model), ("data", "model"), device)


def _mesh(shape, axes, device) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)
