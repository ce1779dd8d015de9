"""Selective state-space (Mamba-2 / SSD style) blocks, chunk-parallel.

The port of ``repro.models.ssm``.  The recurrence

    H_t = a_t * H_{t-1} + k_t (x) v_t        y_t = q_t . H_t

with a scalar per-head decay ``a_t`` is computed in chunked form: the
intra-chunk terms as (L x L) masked products, the inter-chunk terms as a
loop over the chunk summaries, all in float32.  No kernel computes it in
the reference (its TPU form is einsums and a ``lax.scan``), so the port is
plain PyTorch on every device.  Decode is the O(1) recurrent step on the
carried state.

**On a mesh.**  Under a step builder's sharding context the block runs on
``DTensor`` s (:func:`_ssm_mesh`) with the recurrence on each rank's block
of the state as the sharding rules store it (``cache_specs``: the heads
over ``"model"`` where they divide it, else the head dim, else whole): the
recurrence contracts over the state dim ``n``, never over a head's
channels, so it runs on that block with no collective, and the state is
read and written in place in its own blocks.  The depthwise conv runs per
channel where its weight and its rolling window are stored (the inner
channels in contiguous blocks over ``"model"``) or, where a product's
rows outnumber the model width (train, prefill), on the recurrence's
channels with its weight gathered; the gates (``wbc``, ``wdt``) contract
every channel, so their partial sums are reduced ((B, S, 2n + nh), small).
``in_proj``'s two halves do not align with its stored column blocks, so
each rank takes its channels of both through
:func:`~repro_torch.distributed.ctx.mesh_cols`, which gathers the weight or
the product, whichever is smaller.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.ctx import is_dtensor
from .layers import _normal, init_dense, leaf_dtype


class SSMState(NamedTuple):
    h: torch.Tensor       # (B, nh, dk, dv) recurrent state, float32
    conv: torch.Tensor    # (B, w-1, di) rolling conv input window, float32


# ---------------------------------------------------------------------------
# Chunked gated linear recurrence (shared by SSM and mLSTM)
# ---------------------------------------------------------------------------

def ssd_chunked(q, k, v, log_a, chunk: int, h0=None):
    """q, k (B, S, nh, dk); v (B, S, nh, dv); log_a (B, S, nh), the log decay
    in (-inf, 0]; ``h0`` (B, nh, dk, dv) or None.  Returns (y (B, S, nh,
    dv), h_last (B, nh, dk, dv)), float32 throughout."""
    B, S_in, nh, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, S_in)
    # pad to a chunk multiple: k = v = 0 and log_a = 0 add nothing to the state
    pad = (-S_in) % L
    if pad:
        def zpad(a):
            return F.pad(a, [0, 0] * (a.ndim - 2) + [0, pad])

        q, k, v, log_a = zpad(q), zpad(k), zpad(v), zpad(log_a)
    S = S_in + pad
    nc = S // L

    f32 = torch.float32
    qc = q.reshape(B, nc, L, nh, dk).to(f32)
    kc = k.reshape(B, nc, L, nh, dk).to(f32)
    vc = v.reshape(B, nc, L, nh, dv).to(f32)
    lac = log_a.reshape(B, nc, L, nh).to(f32)

    A = torch.cumsum(lac, dim=2)                      # (B, nc, L, nh) incl. own step
    A_last = A[:, :, -1:, :]                          # (B, nc, 1, nh)

    # intra-chunk: y_t += sum_{s<=t} exp(A_t - A_s) (q_t.k_s) v_s
    qk = torch.einsum("bclhd,bcmhd->bchlm", qc, kc)   # (B, nc, nh, L, L)
    At = A.permute(0, 1, 3, 2)                        # (B, nc, nh, L)
    decay = At[..., :, None] - At[..., None, :]       # A_t - A_s
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    # mask the exponent BEFORE exp: above the diagonal A_t - A_s > 0 and exp
    # would overflow (it is discarded anyway)
    decay = torch.where(causal, decay, -torch.inf)
    scores = qk * torch.exp(decay)
    y_intra = torch.einsum("bchlm,bcmhv->bclhv", scores, vc)

    # chunk summaries: S_c = sum_s exp(A_last - A_s) k_s (x) v_s
    w = torch.exp(A_last - A)                         # (B, nc, L, nh)
    S_c = torch.einsum("bclhd,bclhv->bchdv", w[..., None] * kc, vc)
    a_chunk = torch.exp(A_last[:, :, 0, :])           # (B, nc, nh) total chunk decay

    # inter-chunk recurrence; h_ins[c] is the state entering chunk c
    h = torch.zeros((B, nh, dk, dv), dtype=f32, device=q.device) if h0 is None else h0.to(f32)
    h_ins = []
    for c in range(nc):
        h_ins.append(h)
        h = h * a_chunk[:, c, :, None, None] + S_c[:, c]
    h_ins = torch.stack(h_ins, dim=1)                 # (B, nc, nh, dk, dv)

    # cross-chunk contribution: y_t += exp(A_t) q_t . H_in(chunk)
    qw = qc * torch.exp(A)[..., None]                 # (B, nc, L, nh, dk)
    y_cross = torch.einsum("bclhd,bchdv->bclhv", qw, h_ins)

    y = (y_intra + y_cross).reshape(B, S, nh, dv)[:, :S_in]
    return y, h


def ssd_step(q, k, v, log_a, h):
    """The O(1) decode step: q, k (B, nh, dk), v (B, nh, dv), log_a (B, nh),
    h (B, nh, dk, dv).  Returns (y (B, nh, dv), h_new), float32."""
    f32 = torch.float32
    a = torch.exp(log_a.to(f32))[..., None, None]
    h_new = h.to(f32) * a + torch.einsum("bhd,bhv->bhdv", k.to(f32), v.to(f32))
    y = torch.einsum("bhd,bhdv->bhv", q.to(f32), h_new)
    return y, h_new


# ---------------------------------------------------------------------------
# Mamba-style block (hymba's SSM half)
# ---------------------------------------------------------------------------

def ssm_dims(cfg: ModelConfig) -> tuple[int, int]:
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.head_dim
    return di, nh


def init_ssm(generator, cfg: ModelConfig, device, served: bool = False) -> dict:
    d = cfg.d_model
    di, nh = ssm_dims(cfg)
    n = cfg.ssm_state
    pd = cfg.param_dtype
    dt = functools.partial(leaf_dtype, cfg, served=served)
    return {
        "in_proj": init_dense(generator, (d, 2 * di), dt("in_proj"), device, fan_in=d),
        "conv": _normal(generator, (cfg.ssm_conv_width, di), 0.2, dt("conv"), device),
        "wbc": init_dense(generator, (di, 2 * n), dt("wbc"), device, fan_in=di),
        "wdt": init_dense(generator, (di, nh), dt("wdt"), device, fan_in=di),
        "a_log": torch.zeros((nh,), dtype=pd, device=device),       # A = exp(a_log) > 0
        "d_skip": torch.ones((nh,), dtype=pd, device=device),
        "out_proj": init_dense(generator, (di, d), dt("out_proj"), device, fan_in=di),
        "dt_bias": torch.full((nh,), -1.0, dtype=dt("dt_bias"), device=device),
    }


def _causal_conv(x, w, state):
    """Depthwise causal conv of width W: x (B, S, di), w (W, di), ``state``
    (B, W-1, di) or None (zeros).  Returns (out, the last W-1 inputs)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, S+W-1, di)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    new_state = xp[:, xp.shape[1] - (W - 1):, :] if W > 1 else torch.zeros_like(pad)
    return out, new_state


def _ssm_gates(bc, dt, dt_bias, a_log):
    """q, k and log_a from the conv output's products ``bc = xc @ wbc`` (B,
    S, 2n) and ``dt = xc @ wdt`` (B, S, nh), and the heads' ``dt_bias`` and
    ``a_log``."""
    b_in, c_out = torch.chunk(bc, 2, dim=-1)           # (B, S, n) each
    dt = F.softplus(dt + dt_bias.to(bc.dtype))
    a_pos = torch.exp(a_log.float())                  # (nh,)
    log_a = -dt.float() * a_pos                       # (B, S, nh)
    # dt also scales the input (Mamba discretization: B <- dt * B)
    k = b_in[:, :, None, :] * dt[..., None]           # (B, S, nh, n)
    q = c_out[:, :, None, :].expand(k.shape)          # (B, S, nh, n)
    return q, k, log_a


def _ssm_core(x, p, cfg: ModelConfig, conv_state, h0):
    """The shared body of train and prefill: (out, h_last, conv state)."""
    cd = cfg.compute_dtype
    di, nh = ssm_dims(cfg)
    B, S, _ = x.shape
    xi, z = torch.chunk(torch.matmul(x, p["in_proj"].to(cd)), 2, dim=-1)
    xc, conv = _causal_conv(xi, p["conv"].to(cd), conv_state)
    xc = F.silu(xc)
    q, k, log_a = _ssm_gates(torch.matmul(xc, p["wbc"].to(cd)), torch.matmul(xc, p["wdt"].to(cd)),
                             p["dt_bias"], p["a_log"])
    v = xc.reshape(B, S, nh, cfg.head_dim)
    y, h_last = ssd_chunked(q, k, v, log_a, cfg.attn_chunk or 256, h0=h0)
    y = y + v.float() * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(B, S, di).to(cd) * F.silu(z)
    return torch.matmul(y, p["out_proj"].to(cd)), h_last, conv


def _ssm_mesh(x, p, cfg: ModelConfig, state: SSMState | None = None, step: bool = False):
    """The block on ``DTensor`` s, as the module's docstring sets out: the
    full-sequence SSM (``step`` False; with ``state``, from ``state.h`` and a
    conv of zeros, as prefill) or the decode step (``step``: x (B, 1, D)),
    the state written in place.  Returns the output (B, S, D), whole over
    ``"model"`` (under sequence parallelism, its sequence gathered at entry
    and the output reduce-scattered onto it)."""
    from torch.distributed.tensor import Shard

    from ..distributed.ctx import (
        block_layout,
        channels,
        gather_channels,
        gather_sequence,
        local_rows,
        mesh_cols,
        mesh_rows,
        mine,
        model_axis_size,
        read_channels,
        state_block,
        store_block,
        weight_part,
        write_channels,
    )

    cd = cfg.compute_dtype
    di, nh = ssm_dims(cfg)
    hd, W = cfg.head_dim, cfg.ssm_conv_width
    x = gather_sequence(x)          # the recurrence reads the whole sequence
    B, S, D = x.shape
    mesh = x.device_mesh
    tp = model_axis_size()
    axis = 0 if nh % tp == 0 else 1 if hd % tp == 0 else None
    rec = channels((nh, hd), axis)                  # the recurrence's channels (the state's)
    split = len(rec) > 1
    xp, yp = block_layout(x, split)
    rows = local_rows(x, xp)
    # the conv where its weight and window are stored, unless a weight is
    # the smaller thing to move (more rows than the model width)
    conv_ch = channels((di,), 0) if split and rows < D and di % tp == 0 else rec
    same = conv_ch is rec or all(a.equal(b) for a, b in zip(conv_ch, rec))
    y_in = mesh_cols(x, p["in_proj"].to(cd), [torch.cat([a, di + b]) for a, b in zip(conv_ch, rec)])
    xi, z = y_in.split([len(conv_ch[0]), len(rec[0])], dim=-1)
    # host indices, as channels() makes them: they pick each rank's block
    w_conv = weight_part(p["conv"].to(cd), [(torch.arange(W)[:, None] * di + c).reshape(-1)  # repro-torch-lint: disable=RPT005
                                            for c in conv_ch], yp).reshape(W, -1)
    conv_state = None
    if step:
        conv_state = read_channels(state.conv, conv_ch)
    xc, conv = _causal_conv(xi, w_conv, conv_state)
    xc = F.silu(xc)
    heads = channels((nh,), axis if axis == 0 else None)
    bc = mine(mesh_rows(xc, conv_ch, p["wbc"].to(cd), x), channels((2 * cfg.ssm_state,)), split)
    dt = mine(mesh_rows(xc, conv_ch, p["wdt"].to(cd), x), heads, split)
    q, k, log_a = _ssm_gates(bc, dt, weight_part(p["dt_bias"], heads, yp),
                             weight_part(p["a_log"], heads, yp))
    if not same:
        xc = mine(gather_channels(xc, conv_ch, x), rec, split)
    nh_l = nh // tp if axis == 0 else nh
    v = xc.reshape(*xc.shape[:2], nh_l, -1)
    h_layout = list(xp)
    if split:
        h_layout[mesh.mesh_dim_names.index("model")] = Shard(1 if axis == 0 else 3)
    h0 = None if state is None else state_block(state.h, h_layout)
    if step:
        y, h_last = ssd_step(q[:, 0], k[:, 0], v[:, 0], log_a[:, 0], h0)
        y = y[:, None]
    else:
        y, h_last = ssd_chunked(q, k, v, log_a, cfg.attn_chunk or 256, h0=h0)
    d_skip = weight_part(p["d_skip"], heads, yp).float()
    y = y + v.float() * d_skip[None, None, :, None]
    y = y.reshape(*y.shape[:2], -1).to(cd) * F.silu(z)
    out = mesh_rows(y, rec, p["out_proj"].to(cd), x, seq=True)
    if state is not None:
        store_block(state.h, h_last, h_layout)
        write_channels(state.conv, conv.float(), conv_ch)
    return out


def ssm_train(x, p, cfg: ModelConfig):
    """x (B, S, D) -> (B, S, D): the full-sequence chunked SSM."""
    if is_dtensor(x):
        return _ssm_mesh(x, p, cfg)
    return _ssm_core(x, p, cfg, None, None)[0]


def init_ssm_state(cfg: ModelConfig, batch: int, device) -> SSMState:
    di, nh = ssm_dims(cfg)
    return SSMState(
        h=torch.zeros((batch, nh, cfg.ssm_state, cfg.head_dim), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, di), dtype=torch.float32,
                         device=device),
    )


def ssm_prefill(x, p, cfg: ModelConfig, state: SSMState):
    """``ssm_train`` that also writes the final state into ``state``, in
    place.  As the reference, the recurrence starts from ``state.h`` and the
    conv from zeros."""
    if is_dtensor(x):
        return _ssm_mesh(x, p, cfg, state), state
    out, h_last, conv = _ssm_core(x, p, cfg, None, state.h)
    state.h.copy_(h_last)
    state.conv.copy_(conv.float())
    return out, state


def ssm_decode(x, p, cfg: ModelConfig, state: SSMState):
    """One-token step, x (B, 1, D); ``state`` is updated in place."""
    if is_dtensor(x):
        return _ssm_mesh(x, p, cfg, state, step=True), state
    cd = cfg.compute_dtype
    di, nh = ssm_dims(cfg)
    B = x.shape[0]
    xi, z = torch.chunk(torch.matmul(x, p["in_proj"].to(cd)), 2, dim=-1)
    xc, conv = _causal_conv(xi, p["conv"].to(cd), state.conv)
    xc = F.silu(xc)
    q, k, log_a = _ssm_gates(torch.matmul(xc, p["wbc"].to(cd)), torch.matmul(xc, p["wdt"].to(cd)),
                             p["dt_bias"], p["a_log"])
    v = xc.reshape(B, 1, nh, cfg.head_dim)
    y, h_new = ssd_step(q[:, 0], k[:, 0], v[:, 0], log_a[:, 0], state.h)
    y = y + v[:, 0].float() * p["d_skip"].float()[None, :, None]
    y = y.reshape(B, 1, di).to(cd) * F.silu(z)
    state.h.copy_(h_new)
    state.conv.copy_(conv.float())
    return torch.matmul(y, p["out_proj"].to(cd)), state
