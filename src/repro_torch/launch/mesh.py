"""Production mesh construction.

A FUNCTION (not a module-level constant) so importing never touches device
or process-group state.  Single pod: 16 x 16 = 256 ranks (data x model).
Multi-pod: 2 x 16 x 16 = 512 ranks (pod x data x model); the 'pod' axis is
pure DP over the inter-pod links, 'data' is FSDP, 'model' is TP.

The port of ``repro.launch.mesh``.  :func:`make_production_mesh` builds a
``DeviceMesh`` over the ``torch.distributed`` process group that is running
(one process per rank); the sharding rules
(:mod:`repro_torch.distributed.sharding`) also plan on its shape alone,
with no group.  :func:`make_host_mesh` stays the one device this process
runs on, the trainer's.
"""
from __future__ import annotations

import math

import torch

from ..core.provision import _resolve_device


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` one, of ``device``'s type (the
    card unless given ``"cpu"``), over the running process group.
    ``ValueError`` naming the world size it needs unless the group has
    exactly 256 (512) ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else None
    if world != need:
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a process group of "
            f"{need} ranks; " + ("none is running" if world is None
                                 else f"the running one has {world}"))
    device = _resolve_device(device, "make_production_mesh")
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1, device="cuda") -> torch.device:
    """The one device this process runs on: ``device`` (the card unless
    given ``"cpu"``; without CUDA the default raises).  ``model_parallel``
    is clamped to that one device, as the reference clamps it to the
    devices it has."""
    return _resolve_device(device, "make_host_mesh")
