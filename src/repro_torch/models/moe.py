"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch.

The port of ``repro.models.moe``.  Each sequence is one routing group: its
(token, choice) pairs are ranked per expert by a stable sort, those past
the expert's capacity C are dropped (the residual path carries them), and
the rest are scattered into a (E, C, D) buffer whose last extra row is the
trash row of the dropped pairs.  The experts' SwiGLU runs as batched
matrix products over the stacked expert weights; the reference computes it
with einsums outside any kernel, so here it stays PyTorch's product.  The
router runs in float32.  The reference's sharding constraint on the buffer
is a no-op outside a mesh, and the port has none.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
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


def moe_layer(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """x (B, S, D) -> (y, aux loss); the router and the aux loss in float32."""
    cd = cfg.compute_dtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k

    logits = torch.matmul(x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)          # (B, S, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))                                   # (E,)
    ce = torch.nn.functional.one_hot(expert_idx, E).float().mean(dim=(0, 1, 2))
    aux = E * torch.sum(me * ce)

    C = expert_capacity(cfg, S)
    flat_e = expert_idx.reshape(B, S * K)                         # per-group pairs
    pos = _position_in_expert(flat_e, E)                          # (B, S*K)
    keep = pos < C
    dest = torch.where(keep, flat_e * C + pos, E * C)             # (B, S*K)

    # scatter into the per-group (E*C+1, D) buffer (last row = trash)
    tok_rep = torch.repeat_interleave(x.to(cd), K, dim=1)         # (B, S*K, D)
    rows = torch.arange(B, device=x.device)[:, None]
    buf = torch.zeros((B, E * C + 1, D), dtype=cd, device=x.device)
    buf[rows, dest] = tok_rep
    buf = buf[:, :E * C].reshape(B, E, C, D)

    # the experts' SwiGLU, batched over the stacked expert weights
    h = torch.einsum("becd,edf->becf", buf, p["wi"].to(cd))
    g = torch.einsum("becd,edf->becf", buf, p["wg"].to(cd))
    out = torch.einsum("becf,efd->becd", h * activation(g, cfg.act), p["wo"].to(cd))

    # gather back and combine with the gates
    out_flat = torch.cat([out.reshape(B, E * C, D),
                          torch.zeros((B, 1, D), dtype=cd, device=x.device)], dim=1)
    gathered = out_flat[rows, dest]                               # (B, S*K, D)
    gates = (gate_vals.reshape(B, S * K) * keep).to(cd)
    y = (gathered * gates[..., None]).reshape(B, S, K, D).sum(dim=2)
    return y, aux
