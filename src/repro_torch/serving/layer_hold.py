"""The per-layer hold of a served model, teacher-forced.

:func:`layers_held` runs a greedy stream on the plain route
(``kernel=False``) through :class:`~repro_torch.serving.InferenceEngine`,
and every call of a layer on both routes with the same input: the plain
route's residual stream.  It holds the kernel route layer by layer, where
a whole-stream comparison would mix the kernels' error with the routing
flips of a mixture-of-experts model, whose near-ties part two bf16 routes
after a few layers.  On CPU tensors both calls take the plain route, so
the hold gives 0 there; a planted fault must still fail it.
"""
from __future__ import annotations

import itertools

import torch

from ..models import blocks, moe, transformer
from .engine import InferenceEngine


class LayerHoldError(AssertionError):
    """A layer's kernel route is farther from its plain route than the
    hold allows (or not finite)."""


def row_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Largest |got - want| of each row (the last axis) over that row's
    largest |want|."""
    err = (got.float() - want.float()).abs().amax(dim=-1)
    return err / want.float().abs().amax(dim=-1).clamp_min(1e-30)


def _held(cond: bool, msg: str) -> None:
    if not cond:
        raise LayerHoldError(msg)


def layers_held(cfg, params, prompt, n_new, device, tol, what, fault=None) -> dict:
    """The per-layer hold, teacher-forced: the plain route runs a prefill
    of ``prompt`` ((B, S) tokens) and ``n_new - 1`` greedy decode steps,
    and every call of a layer (``blocks.layer_prefill``, ``layer_decode``)
    first runs on the kernel route, then on the plain route, with the same
    input and the same cache (the plain call writes it last, with the same
    rows); the plain call's output goes on.  Each call holds the kernel
    route's attention output (the layer's K3 or K4 call, projected by
    ``wo``) on every row, and its layer output on the rows whose routing is
    the plain route's, within ``tol`` of the plain row's largest value;
    rows whose routing differs are left out of the second and counted.  A
    token's routing is its top-k expert set and which of those picks its
    sequence's expert capacity keeps: a near-tie that flips one token's set
    moves the capacity ranks of the tokens after it, so it can drop or keep
    a pick of a token whose own set did not change.  ``fault(kind, step,
    layer, p)`` gives the kernel route's layer parameters (a planted
    fault).  Raises :class:`LayerHoldError` naming the call (``what``,
    prefill or decode, the step and the layer).  Returns the largest row
    distances of the attention outputs and of the layer outputs, the rows
    left out and the rows compared."""
    stats = {"attn": 0.0, "out": 0.0, "left_out": 0, "rows": 0}
    seen = {}
    attn = blocks.prefill_attention, blocks.decode_attention
    moe_layer = blocks.moe_layer

    def attn_seen(original):
        def attention(*args, **kw):
            out = original(*args, **kw)
            seen["attn"] = out[0]
            return out

        return attention

    def moe_seen(x, p, cfg_):
        idx = moe._route(x, p["router"], cfg_)[2]                 # (B, S, K)
        b, s, k = idx.shape
        kept = (moe._position_in_expert(idx.reshape(b, s * k), cfg_.n_experts)
                < moe.expert_capacity(cfg_, s)).reshape(b, s, k)
        routed = torch.zeros((b, s, cfg_.n_experts), dtype=torch.int8, device=x.device)
        seen["experts"] = routed.scatter_(-1, idx, 1 + kept.to(torch.int8))  # 2: kept
        return moe_layer(x, p, cfg_)

    def twice(original, kind):
        calls = itertools.count()

        def layer(p, cfg_, x, where, cache, flag=False, kernel=True):
            step, i = divmod(next(calls), cfg.n_layers)
            seen.clear()
            pk = p if fault is None else fault(kind, step, i, p)
            got, _ = original(pk, cfg_, x, where, cache, flag, kernel=True)
            got_seen = dict(seen)
            seen.clear()
            want, cache = original(p, cfg_, x, where, cache, flag, kernel=False)
            at = f"{what} {kind} step {step} layer {i}"
            _held(bool(torch.isfinite(got).all()), f"{at}: the kernel route's output")
            if "attn" in seen:
                rel = float(row_err(got_seen["attn"], seen["attn"]).max())
                _held(rel <= tol, f"{at}: the kernel route's attention output is {rel:.3e} "
                      f"of a row's largest value from the plain route's, above {tol}")
                stats["attn"] = max(stats["attn"], rel)
            same = torch.ones(got.shape[:-1], dtype=torch.bool, device=got.device)
            if "experts" in seen:
                same = (got_seen["experts"] == seen["experts"]).all(-1)
            rows = int(same.numel())
            stats["rows"] += rows
            stats["left_out"] += rows - int(same.sum())
            if same.any():
                rel = float(row_err(got[same], want[same]).max())
                _held(rel <= tol, f"{at}: the kernel route's output is {rel:.3e} of a row's "
                      f"largest value from the plain route's, above {tol}")
                stats["out"] = max(stats["out"], rel)
            return want, cache

        return layer

    prefill, decode = transformer.layer_prefill, transformer.layer_decode
    B, S = prompt.shape
    try:
        blocks.prefill_attention, blocks.decode_attention = map(attn_seen, attn)
        blocks.moe_layer = moe_seen
        transformer.layer_prefill = twice(prefill, "prefill")
        transformer.layer_decode = twice(decode, "decode")
        InferenceEngine(cfg, params, max_batch=B, max_seq=S + n_new, device=device,
                        kernel=False).generate(prompt, n_new)
    finally:
        blocks.prefill_attention, blocks.decode_attention = attn
        blocks.moe_layer = moe_layer
        transformer.layer_prefill, transformer.layer_decode = prefill, decode
    return stats
