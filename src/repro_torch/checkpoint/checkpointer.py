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
Restoring onto another mesh (the reference's elastic path) waits for
``distributed/elastic.py``, which needs the sharding rules of the sharded
step builders (ROADMAP.md, Queue 1 item F).

Atomicity: everything is written into ``step_<k>.tmp`` and renamed — a crash
mid-write never corrupts the latest complete checkpoint.  ``Checkpointer``
runs saves on a background thread (training never blocks on I/O) and keeps
the most recent ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_paths, tree_unflatten


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own: a copy, never a view of a tensor
    that training goes on updating in place."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(directory: str | Path, step: int, tree: Any, extra: dict | None = None) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves = tree_leaves(tree)
    manifest = {
        "step": step,
        "paths": tree_paths(tree),
        "n_leaves": len(leaves),
        "leaves": [],
        "extra": extra or {},
    }
    for i, leaf in enumerate(leaves):
        arr = leaf if isinstance(leaf, np.ndarray) else _host(leaf)
        np.save(tmp / f"arr_{i}.npy", arr)
        manifest["leaves"].append({"shape": list(arr.shape), "dtype": str(arr.dtype)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
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


def restore(directory: str | Path, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf a tensor with the
    saved array's dtype, on the device of ``like``'s matching leaf.
    ``ValueError`` if the leaf count or a shape differs."""
    path = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    like_leaves = tree_leaves(like)
    if manifest["n_leaves"] != len(like_leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target {len(like_leaves)}")
    out = []
    for i, ref in enumerate(like_leaves):
        arr = np.load(path / f"arr_{i}.npy")
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: {arr.shape} != {tuple(ref.shape)}")
        out.append(torch.as_tensor(arr, device=ref.device))
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
