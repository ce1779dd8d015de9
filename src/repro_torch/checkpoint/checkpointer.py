"""Atomic, asynchronous checkpointing of trees of tensors.

Layout: <dir>/step_<k>/
          manifest.json       leaf paths + shapes/dtypes + step metadata
          arr_<i>.npy         one file per leaf (the full array)

The port of ``repro.checkpoint.checkpointer``, with its layout.  With no
jax treedef, leaves are numbered in the fixed order of
:func:`repro_torch.utils.tree.tree_leaves` (a dict's values by sorted key,
a list's or tuple's in index order) and the manifest names each leaf's path
(``"0/blocks/3/attn/wq"``); :func:`restore` fills the structure of the tree
it is given in that order, each leaf on the device of the matching leaf.
Sharded trees (the reference's elastic path): :func:`save` takes
``DTensor`` leaves and writes each full array, and :func:`restore` with
``shardings=`` gives each leaf as a ``DTensor``, every rank reading only its
own block of the file; :func:`repro_torch.distributed.elastic.reshard_restore`
restores onto any mesh.

Atomicity: everything is written into ``step_<k>.tmp`` and renamed — a crash
mid-write never corrupts the latest complete checkpoint.  ``Checkpointer``
runs saves on a background thread (training never blocks on I/O) and keeps
the most recent ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import math
import shutil
import sys
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_leaves_up_to, tree_paths, tree_unflatten


def _is_dtensor(leaf) -> bool:
    tensor = sys.modules.get("torch.distributed.tensor")   # no DTensor unless it is loaded
    return tensor is not None and isinstance(leaf, tensor.DTensor)


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own: a copy, never a view of a tensor
    that training goes on updating in place.  A ``DTensor`` is gathered
    whole (a collective: every rank of its mesh must call this)."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(directory: str | Path, step: int, tree: Any, extra: dict | None = None) -> Path:
    """Write ``tree`` as step ``step`` under ``directory``.  A tree with
    ``DTensor`` leaves is saved by every rank of the world at once: each
    such leaf is gathered whole, rank 0 writes, and every rank returns
    after a barrier, the checkpoint complete."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    leaves = tree_leaves(tree)
    sharded = any(_is_dtensor(leaf) for leaf in leaves)
    writes = True
    if sharded:
        import torch.distributed as dist

        writes = dist.get_rank() == 0
    if writes:
        directory.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

    manifest = {
        "step": step,
        "paths": tree_paths(tree),
        "n_leaves": len(leaves),
        "leaves": [],
        "extra": extra or {},
    }
    for i, leaf in enumerate(leaves):
        arr = leaf if isinstance(leaf, np.ndarray) else _host(leaf)
        if writes:
            np.save(tmp / f"arr_{i}.npy", arr)
        manifest["leaves"].append({"shape": list(arr.shape), "dtype": str(arr.dtype)})
    if writes:
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
    if sharded:
        dist.barrier()
    return final


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in directory.iterdir()
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
        and (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


def _block(shape: tuple[int, ...], mesh, placements) -> tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` placed by ``placements``
    on ``mesh``: each ``Shard(d)`` splits dim ``d``'s current range as
    ``torch.chunk`` does (pieces of ceil(n / size), the last ones short or
    empty), mesh dim by mesh dim, as DTensor splits it."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("restore: this rank is not in the mesh it restores onto")
    index = [slice(0, n) for n in shape]
    for i, p in enumerate(placements):
        if p.is_replicate():
            continue
        if not p.is_shard():
            raise ValueError(f"restore places by Shard and Replicate only, got {p}")
        lo, hi = index[p.dim].start, index[p.dim].stop
        piece = math.ceil((hi - lo) / mesh.size(i))
        start = min(lo + coord[i] * piece, hi)
        index[p.dim] = slice(start, min(start + piece, hi))
    return tuple(index)


def _restore_sharded(file: Path, shape: tuple[int, ...], mesh, placements):
    """The saved array as a ``DTensor`` on ``mesh``: this rank reads its
    own block from the file (a memory map) and no collective runs."""
    from torch.distributed.tensor import DTensor

    block = np.load(file, mmap_mode="r")[_block(shape, mesh, placements)]
    local = torch.from_numpy(np.array(block, order="C")).to(mesh.device_type)
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def restore(directory: str | Path, step: int, like: Any, shardings: Any | None = None) -> Any:
    """Restore into the structure of ``like``: each leaf a tensor with the
    saved array's dtype, on the device of ``like``'s matching leaf.  With
    ``shardings`` (a tree of ``like``'s structure whose leaves are
    ``(mesh, placements)`` pairs, :class:`~repro_torch.distributed.sharding.Sharding`
    or None), each leaf that has one comes as a ``DTensor`` with those
    placements: every rank of the mesh calls this and holds only its own
    blocks — restoring onto a different mesh than the one that saved is the
    elastic-resize path.  ``ValueError`` if the leaf count or a shape
    differs."""
    path = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    like_leaves = tree_leaves(like)
    if manifest["n_leaves"] != len(like_leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target {len(like_leaves)}")
    shard_leaves = (tree_leaves_up_to(like, shardings) if shardings is not None
                    else [None] * len(like_leaves))
    out = []
    for i, (ref, shd) in enumerate(zip(like_leaves, shard_leaves)):
        file = path / f"arr_{i}.npy"
        shape = tuple(manifest["leaves"][i]["shape"])
        if shape != tuple(ref.shape):
            raise ValueError(f"leaf {i}: {shape} != {tuple(ref.shape)}")
        if shd is None:
            out.append(torch.as_tensor(np.load(file), device=ref.device))
        else:
            mesh, placements = shd
            out.append(_restore_sharded(file, shape, mesh, tuple(placements)))
    return tree_unflatten(like, out)


class Checkpointer:
    """Async checkpoint manager with retention."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save_async(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self.wait()
        # copy to the host BEFORE handing to the thread: training updates
        # the parameters and the optimizer state in place
        host_tree = tree_unflatten(tree, [_host(x) for x in tree_leaves(tree)])

        def work():
            try:
                save(self.directory, step, host_tree, extra)
                self._gc()
            except Exception as e:  # noqa: BLE001  (re-raised by wait())
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.directory.iterdir()
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)

    def latest(self) -> int | None:
        return latest_step(self.directory)
