"""A world of local processes over ``torch.distributed``, one per rank.

:func:`run_world` starts ``world_size`` processes with
``torch.multiprocessing.start_processes``.  Each joins one process group on
a ``FileStore`` in a work directory, builds a ``DeviceMesh`` on the
requested device type (one axis ``("data",)`` unless given another shape
and axis names), calls a target function ``fn(mesh, payload)`` and saves
what it returns there; the function may build further meshes over the
same world with ``init_device_mesh``.  The caller gets
every rank's return value, in rank order; no process group is ever created
in the calling process.  A rank that fails stops the whole world, and its
traceback is raised::

    results = run_world("my_module:fn", 4, device="cpu", payload=cases)

The backend defaults to NCCL on CUDA and gloo on the CPU; several ranks that
share one card pass ``backend="gloo"``, whose collectives take their CUDA
operands through the host (:mod:`repro_torch.core.torch_provision` moves
them explicitly).  On CUDA rank ``r`` works on card ``r`` modulo the number
of cards.
"""
from __future__ import annotations

import contextlib
import datetime
import importlib
import math
import pathlib
import tempfile
import time

import torch
import torch.multiprocessing as mp

#: seconds a rank waits for the others in a collective or the rendezvous
GROUP_TIMEOUT_S = 120


def run_world(target: str, world_size: int, *, device: str = "cuda", backend: str | None = None,
              payload=None, timeout: float = GROUP_TIMEOUT_S, workdir=None,
              mesh_shape: tuple[int, ...] | None = None,
              mesh_dim_names: tuple[str, ...] = ("data",)) -> list:
    """Run ``target`` (``"module:function"``) on ``world_size`` local ranks.

    Each rank imports ``module`` (the ranks see the caller's ``sys.path``)
    and calls ``function(mesh, payload)`` with its ``DeviceMesh`` of shape
    ``mesh_shape`` (default ``(world_size,)``) and axes ``mesh_dim_names``
    (default ``("data",)``), device type ``device``; ``ValueError`` if the
    shape does not hold ``world_size`` ranks or the names do not match it.
    ``payload`` is anything ``torch.save`` takes; its tensors are loaded
    onto the rank's device.  A rank's return value comes back through
    ``torch.save``, loaded onto the CPU.  ``workdir``: an empty directory for the store, the payload
    and the results (default: a temporary directory, removed afterwards).
    Raises ``torch.multiprocessing.ProcessException`` with the failing
    rank's traceback if a rank fails, and ``TimeoutError`` after
    ``timeout`` seconds; either way every rank is stopped first.
    """
    mesh_shape = tuple(mesh_shape or (world_size,))
    if math.prod(mesh_shape) != world_size or len(mesh_dim_names) != len(mesh_shape):
        raise ValueError(f"a mesh of shape {mesh_shape} and axes {tuple(mesh_dim_names)} "
                         f"for a world of {world_size}")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    with contextlib.ExitStack() as stack:
        tmp = pathlib.Path(workdir if workdir is not None else stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro_torch_world_")))
        torch.save(payload, tmp / "payload.pt")
        ctx = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(target, world_size, str(tmp), backend, device, min(timeout, GROUP_TIMEOUT_S),
                  mesh_shape, tuple(mesh_dim_names)),
        )
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"a world of {world_size} not done in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(tmp / f"rank{r}.pt", map_location="cpu", weights_only=False)
                for r in range(world_size)]


def _rank_main(rank, target, world, workdir, backend, device, timeout, mesh_shape,
               mesh_dim_names) -> None:
    """One rank of :func:`run_world`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    tmp = pathlib.Path(workdir)
    here = torch.device("cpu")
    if torch.device(device).type == "cuda":
        here = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(here)
    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    payload = torch.load(tmp / "payload.pt", map_location=here, weights_only=False)
    dist.init_process_group(
        backend, store=dist.FileStore(str(tmp / "store"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout),
    )
    try:
        mesh = init_device_mesh(device, mesh_shape, mesh_dim_names=mesh_dim_names)
        torch.save(fn(mesh, payload), tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
