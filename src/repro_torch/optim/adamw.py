"""AdamW with global-norm clipping, on trees of tensors.

The port of ``repro.optim.adamw``: the reference's configuration, schedule
(linear warmup, cosine decay to ``lr_min_ratio`` of the peak), clipping,
bias corrections and decoupled weight decay, with float32 moments and the
same formulas in the same order of operations.  Where the reference returns
new trees, :func:`adamw_update` writes the parameters and the moments in
place, under ``torch.no_grad()``: a full-width model's moments take four
times its parameters' bytes, and a copy per step would double that.  Not
``torch.optim.AdamW``, whose clipping, schedule and decay differ.

The trees may hold ``DTensor`` s (the sharded train step's): each gradient
is first reduced to its parameter's placements (a partial sum over the data
axis becomes a reduce-scatter), the global norm's sums of squares reduce
across the ranks once per placement, every leaf's update runs on its local
blocks, and nothing is read to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..distributed.ctx import is_dtensor, whole
from ..utils.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # scalar int32
    m: Any                   # first moment, fp32, like params
    v: Any                   # second moment, fp32, like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to lr_min_ratio * peak (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr_peak * cos)


def init_adamw(params: Any) -> AdamWState:
    """Zero moments in float32 like ``params`` (a ``DTensor`` parameter's
    placed as it is, each rank allocating its own block) and a zero step."""
    def zeros():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros(),
                      v=zeros())


def global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if leaves and is_dtensor(leaves[0]):
        return _mesh_global_norm(leaves)
    return torch.sqrt(
        sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))


def _mesh_global_norm(leaves) -> torch.Tensor:
    """The global norm of ``DTensor`` leaves (none a partial sum): each
    rank sums the squares of its blocks, leaves placed alike are added,
    and each such sum is reduced over the mesh dims that shard it, once;
    a replicated scalar."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, sums = leaves[0].device_mesh, {}
    for g in leaves:
        if any(p.is_partial() for p in g.placements):
            raise ValueError("global_norm of a partial sum: reduce it to its placements first")
        key = tuple(Partial() if p.is_shard() else Replicate() for p in g.placements)
        local = torch.sum(torch.square(g.to_local().to(torch.float32)))
        sums[key] = sums[key] + local if key in sums else local
    total = sum(whole(DTensor.from_local(x, mesh, key, run_check=False)).to_local()
                for key, x in sums.items())
    return DTensor.from_local(torch.sqrt(total), mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


@torch.no_grad()
def adamw_update(
    grads: Any, state: AdamWState, params: Any, cfg: AdamWConfig
) -> tuple[Any, AdamWState, dict]:
    """One step.  Returns (params, new_state, metrics): ``params`` and the
    state's moment trees are the trees given, updated in place; the new
    state holds the incremented step."""
    grads = [g.redistribute(p.device_mesh, p.placements)     # reduced onto the param's blocks
             if is_dtensor(g) and tuple(g.placements) != tuple(p.placements) else g
             for g, p in zip(tree_leaves(grads), tree_leaves(params), strict=True)]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    # on DTensors every leaf's update is elementwise on its blocks: the
    # scalars and the leaves as local tensors, written in place
    k_scale, k_lr, k_b1c, k_b2c = (_local(x) for x in (scale, lr, b1c, b2c))

    for g, m, v, p in zip(grads, tree_leaves(state.m), tree_leaves(state.v),
                          tree_leaves(params), strict=True):
        g, m, v, p = (_local(x) for x in (g, m, v, p))
        g = g.to(torch.float32) * k_scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        mhat = m / k_b1c
        vhat = v / k_b2c
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - k_lr * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics


def _local(x):
    """A ``DTensor``'s local block (a view: writes reach the ``DTensor``);
    anything else as it is."""
    return x.to_local() if is_dtensor(x) else x
