"""AdamW with global-norm clipping, on trees of tensors.

The port of ``repro.optim.adamw``: the reference's configuration, schedule
(linear warmup, cosine decay to ``lr_min_ratio`` of the peak), clipping,
bias corrections and decoupled weight decay, with float32 moments and the
same formulas in the same order of operations.  Where the reference returns
new trees, :func:`adamw_update` writes the parameters and the moments in
place, under ``torch.no_grad()``: a full-width model's moments take four
times its parameters' bytes, and a copy per step would double that.  Not
``torch.optim.AdamW``, whose clipping, schedule and decay differ.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

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
    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)

    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros(),
                      v=zeros())


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(
    grads: Any, state: AdamWState, params: Any, cfg: AdamWConfig
) -> tuple[Any, AdamWState, dict]:
    """One step.  Returns (params, new_state, metrics): ``params`` and the
    state's moment trees are the trees given, updated in place; the new
    state holds the incremented step."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
                          tree_leaves(params), strict=True):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        mhat = m / b1c
        vhat = v / b2c
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
