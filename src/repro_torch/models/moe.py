"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch.

The port of ``repro.models.moe``.  Each sequence is one routing group: its
(token, choice) pairs are ranked per expert by a stable sort, those past
the expert's capacity C are dropped (the residual path carries them), and
the rest are scattered into a (E, C, D) buffer whose last extra row is the
trash row of the dropped pairs.  The experts' SwiGLU runs as batched
matrix products over the stacked expert weights; the reference computes it
with einsums outside any kernel, so here it stays PyTorch's product.  The
router runs in float32.  Under a step builder's sharding context the
buffer is pinned as the reference pins it, experts over the ``"model"``
axis (expert parallelism); on a plain tensor that is a no-op.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..distributed.ctx import (
    constrain,
    from_block,
    is_dtensor,
    layout,
    local_block,
    onto_sequence,
    whole,
)
from .layers import activation, init_dense


def init_moe(generator, cfg: ModelConfig, device) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    pd = cfg.param_dtype
    return {
        "router": init_dense(generator, (d, e), torch.float32, device, fan_in=d),
        "wi": init_dense(generator, (e, d, f), pd, device, fan_in=d),
        "wg": init_dense(generator, (e, d, f), pd, device, fan_in=d),
        "wo": init_dense(generator, (e, f, d), pd, device, fan_in=f),
    }


def expert_capacity(cfg: ModelConfig, group_tokens: int) -> int:
    """Per-group (= per sequence) expert capacity, padded to a multiple of 8
    as the reference pads it."""
    c = int(cfg.capacity_factor * group_tokens * cfg.top_k / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def _position_in_expert(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Rank of each (token, choice) among the picks of the same expert, in
    pick order: a stable sort, then each pick's index in the sorted order
    less its expert's first index.  flat_e (..., N) -> int32 ranks."""
    n = flat_e.shape[-1]
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    first = torch.searchsorted(sorted_e.contiguous(),
                               torch.arange(n_experts, device=flat_e.device).expand(
                                   *flat_e.shape[:-1], n_experts).contiguous())
    ranks_sorted = torch.arange(n, device=flat_e.device) - torch.gather(first, -1, sorted_e)
    return torch.zeros_like(flat_e, dtype=torch.int32).scatter_(
        -1, order, ranks_sorted.to(torch.int32))


def _route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """The router's float32 probabilities, the top-k gates (normalised) and
    experts of x (B, S, D)."""
    probs = torch.softmax(torch.matmul(x.float(), router), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)  # (B, S, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def moe_layer(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """x (B, S, D) -> (y, aux loss); the router and the aux loss in float32."""
    if is_dtensor(x):
        return _mesh_moe(x, p, cfg)
    cd = cfg.compute_dtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k

    probs, gate_vals, expert_idx = _route(x, p["router"], cfg)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))                                   # (E,)
    ce = torch.nn.functional.one_hot(expert_idx, E).float().mean(dim=(0, 1, 2))
    aux = E * torch.sum(me * ce)

    buf, dest, keep = _dispatch(x, expert_idx, cfg)
    buf = constrain(buf, "dp", "model", None, None)               # EP: experts over TP axis

    # the experts' SwiGLU, batched over the stacked expert weights
    h = torch.einsum("becd,edf->becf", buf, p["wi"].to(cd))
    g = torch.einsum("becd,edf->becf", buf, p["wg"].to(cd))
    out = torch.einsum("becf,efd->becd", h * activation(g, cfg.act), p["wo"].to(cd))

    return _combine(out, dest, gate_vals, keep, cfg), aux


def _combine(out, dest, gate_vals, keep, cfg: ModelConfig):
    """The experts' outputs (B, E, C, D) gathered back to each (token,
    choice) pair (the trash row gives the dropped ones zeros) and summed
    with the gates: (B, S, D)."""
    cd = cfg.compute_dtype
    B, E, C, D = out.shape
    K = cfg.top_k
    S = dest.shape[1] // K
    out_flat = torch.cat([out.reshape(B, E * C, D),
                          torch.zeros((B, 1, D), dtype=cd, device=out.device)], dim=1)
    rows = torch.arange(B, device=out.device)[:, None]
    gathered = out_flat[rows, dest]                               # (B, S*K, D)
    gates = (gate_vals.reshape(B, S * K) * keep).to(cd)
    return (gathered * gates[..., None]).reshape(B, S, K, D).sum(dim=2)


def _dispatch(x, expert_idx, cfg: ModelConfig):
    """Each sequence's (token, choice) pairs scattered into its (E, C, D)
    buffer in the compute dtype: (buffer, destination rows, kept pairs)."""
    cd = cfg.compute_dtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = expert_capacity(cfg, S)
    flat_e = expert_idx.reshape(B, S * K)
    pos = _position_in_expert(flat_e, E)
    keep = pos < C
    dest = torch.where(keep, flat_e * C + pos, E * C)
    rows = torch.arange(B, device=x.device)[:, None]
    buf = torch.zeros((B, E * C + 1, D), dtype=cd, device=x.device)
    buf[rows, dest] = torch.repeat_interleave(x.to(cd), K, dim=1)
    return buf[:, :E * C].reshape(B, E, C, D), dest, keep


def _mesh_moe(x, p: dict, cfg: ModelConfig):
    """:func:`moe_layer` on ``DTensor`` s: each rank routes and dispatches
    its batch rows (a sequence is a routing group), the buffer is pinned
    with the experts over ``"model"`` (the reference's constraint), each
    rank runs its experts' SwiGLU on its blocks, and the outputs are
    gathered over ``"model"`` to be combined; the aux loss's means reduce
    over the data axes.  Under sequence parallelism the input's sequence is
    gathered (a sequence is routed whole) and the combined output is cut to
    each rank's own rows of the residual stream (no collective: the
    experts' outputs were gathered, not summed)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    cd, mesh = cfg.compute_dtype, x.device_mesh
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xp = layout(x.shape, "dp", None, None)
    lx = local_block(x, xp, xp)
    probs, gate_vals, expert_idx = _route(lx, local_block(p["router"], [Replicate()] * mesh.ndim,
                                                          xp), cfg)
    sums = torch.cat([probs.sum(dim=(0, 1)),
                      torch.nn.functional.one_hot(expert_idx, E).float().sum(dim=(0, 1, 2))])
    partial = [Partial() if q.is_shard() else Replicate() for q in xp]
    sums = whole(from_block(sums, mesh, partial, (2 * E,)))
    aux = E * torch.sum(sums[:E] / (B * S) * (sums[E:] / (B * S * K)))

    buf, dest, keep = _dispatch(lx, expert_idx, cfg)
    buf = from_block(buf, mesh, xp, (B, E, buf.shape[2], D))
    buf = constrain(buf, "dp", "model", None, None)               # EP: experts over TP axis
    ep = buf.placements
    w_pl = tuple(Shard(0) if q.is_shard(1) else Replicate() for q in ep)
    lb = local_block(buf, ep, ep)
    wi, wg, wo = (local_block(p[k].to(cd), w_pl, ep) for k in ("wi", "wg", "wo"))
    h = torch.einsum("becd,edf->becf", lb, wi)
    g = torch.einsum("becd,edf->becf", lb, wg)
    out = torch.einsum("becf,efd->becd", h * activation(g, cfg.act), wo)
    out = from_block(out, mesh, ep, buf.shape)
    out = local_block(out, tuple(Replicate() if q.is_shard(1) else q for q in ep), xp)
    return onto_sequence(from_block(_combine(out, dest, gate_vals, keep, cfg), mesh, xp,
                                    x.shape)), aux
