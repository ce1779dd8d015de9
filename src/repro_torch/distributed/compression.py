"""Gradient compression with error feedback (cross-pod DP traffic reduction).

int8 per-tensor quantization cuts the inter-pod all-reduce payload 4x
(fp32->int8); the quantization error is carried in an error-feedback buffer
and re-added next step, which keeps SGD/Adam convergence (Seide et al.,
Karimireddy et al.).  The transform wraps the gradient tree, so it also runs
(and is testable) on one device.

The port of ``repro.distributed.compression``: the same formulas on trees
of tensors (:mod:`repro_torch.utils.tree`), each on its tensor's device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..utils.tree import tree_leaves, tree_map, tree_unflatten


class ErrorFeedbackState(NamedTuple):
    residual: Any          # same structure as grads, fp32


def init_error_feedback(params: Any) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``g`` in int8 steps of ``max|g| / 127`` (at least
    1e-12 / 127), rounded half to even and clipped to ±127."""
    scale = torch.clamp(g.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(
    grads: Any, state: ErrorFeedbackState
) -> tuple[Any, ErrorFeedbackState, dict]:
    """Returns (compressed-then-decompressed grads, new EF state, metrics).

    The returned grads are exactly what every pod would see after an int8
    all-reduce; the residual keeps the information the quantizer dropped.
    """

    def one(g, r):
        g32 = g.to(torch.float32) + r
        q, scale = quantize_int8(g32)
        deq = dequantize_int8(q, scale)
        return deq, g32 - deq

    outs = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(state.residual),
                                      strict=True)]
    new_g = tree_unflatten(grads, [o[0] for o in outs])
    new_r = tree_unflatten(grads, [o[1] for o in outs])
    err_norm = torch.sqrt(sum(torch.sum(torch.square(o[1])) for o in outs))
    return new_g, ErrorFeedbackState(residual=new_r), {"ef_residual_norm": err_norm}


def compression_ratio(grads: Any) -> float:
    """fp32 bytes / int8 bytes for the inter-pod payload."""
    return 4.0
