"""Device "mesh" of the port: one device.

The reference builds ``jax.make_mesh`` meshes: a (16, 16) or (2, 16, 16)
production mesh, and a host mesh over the local devices.  The port runs on
one device until the multi-device route lands (ROADMAP.md, Queue 1 item F),
so :func:`make_host_mesh` returns that device and
:func:`make_production_mesh` raises.
"""
from __future__ import annotations

import torch

from ..core.provision import _resolve_device


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "make_production_mesh: the production mesh needs the multi-device route, which "
        "is not ported yet (ROADMAP.md, Queue 1 item F)")


def make_host_mesh(model_parallel: int = 1, device="cuda") -> torch.device:
    """The one device this process runs on: ``device`` (the card unless
    given ``"cpu"``; without CUDA the default raises).  ``model_parallel``
    is clamped to that one device, as the reference clamps it to the
    devices it has."""
    return _resolve_device(device, "make_host_mesh")
