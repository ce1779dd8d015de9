"""Elastic scaling: restore any checkpoint onto any mesh.

Checkpoints store full (unsharded) arrays plus the tree's leaf paths;
sharding is a pure function of (tree, mesh) — ``param_specs`` — so restoring
onto a larger/smaller mesh is just different placements.  Combined with the
provisioning layer this implements the paper's dynamic capacity at the
*training* tier: pods join/leave the data-parallel axis and training resumes
from the latest step with a resharded state.

The port of ``repro.distributed.elastic``: every rank of the mesh calls
:func:`reshard_restore` and reads only its own blocks of each array, as
``DTensor`` leaves; no collective runs.
"""
from __future__ import annotations

from typing import Any

from ..checkpoint import restore
from .sharding import mesh_shape, param_shardings


def reshard_restore(directory: str, step: int, like: Any, mesh) -> Any:
    """Restore ``like``-structured state placed for ``mesh`` (a
    ``DeviceMesh``): each leaf a ``DTensor`` with the training placements
    of :func:`~repro_torch.distributed.sharding.param_specs`.  ``like``
    gives the structure and shapes (tensors, meta tensors or DTensors)."""
    return restore(directory, step, like, shardings=param_shardings(like, mesh))


def global_batch_for(mesh, per_replica_batch: int) -> int:
    """Elastic global batch: scales with the data-parallel extent."""
    sizes = mesh_shape(mesh)
    return per_replica_batch * sizes.get("data", 1) * sizes.get("pod", 1)
