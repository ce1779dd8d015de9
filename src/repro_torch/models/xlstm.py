"""xLSTM blocks: chunk-parallel mLSTM (matrix memory) + sequential sLSTM.

The port of ``repro.models.xlstm``.  mLSTM is a gated linear recurrence on
:func:`~repro_torch.models.ssm.ssd_chunked`; its normalizer state is carried
as an extra value column (v' = [v, 1]), so one matrix state covers both C
and n:

    C_t = f_t C_{t-1} + i_t k_t (x) v_t        n_t = f_t n_{t-1} + i_t k_t
    h_t = o_t * (q_t C_t) / max(|q_t n_t|, 1)

sLSTM keeps per-head scalar memory with exponential gating and a
stabilizer; it is sequential (recurrent gate inputs) and runs as a Python
loop over time, its input product hoisted out of the loop.  At xlstm-1.3b's
width that loop is about 20 small launches per token per sLSTM layer.
Neither calls an attention kernel: xLSTM's head dim (512) is not an
attention head's.  All states are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import init_dense
from .ssm import ssd_chunked, ssd_step


class MLSTMState(NamedTuple):
    h: torch.Tensor       # (B, nh, dk, dv+1) matrix memory incl. normalizer


class SLSTMState(NamedTuple):
    c: torch.Tensor       # (B, nh, hd)
    n: torch.Tensor       # (B, nh, hd)
    m: torch.Tensor       # (B, nh, hd) stabilizer
    y: torch.Tensor       # (B, nh, hd) previous output (recurrent input)


def xlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    di = cfg.ssm_expand * cfg.d_model
    nh = cfg.n_heads
    return di, nh, di // nh


def _project(x, w):
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(generator, cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    di, nh, hd = xlstm_dims(cfg)
    pd = cfg.param_dtype
    return {
        "in_proj": init_dense(generator, (d, 2 * di), pd, device, fan_in=d),
        "wq": init_dense(generator, (di, nh, hd), pd, device, fan_in=di),
        "wk": init_dense(generator, (di, nh, hd), pd, device, fan_in=di),
        "wif": init_dense(generator, (di, 2 * nh), pd, device, fan_in=di),
        "if_bias": torch.cat([torch.zeros((nh,)), torch.full((nh,), 3.0)]).to(
            device=device, dtype=pd),                  # forget bias ~ +3
        "out_proj": init_dense(generator, (di, d), pd, device, fan_in=di),
    }


def _mlstm_qkvg(xi, p, nh, hd):
    cd = xi.dtype
    q = _project(xi, p["wq"].to(cd))
    k = _project(xi, p["wk"].to(cd)) * (hd ** -0.5)
    v = xi.reshape(*xi.shape[:2], nh, hd)
    gates = torch.matmul(xi, p["wif"].to(cd)) + p["if_bias"].to(cd)
    i_gate, f_gate = torch.chunk(gates, 2, dim=-1)    # (B, S, nh)
    log_f = F.logsigmoid(f_gate.float())
    i_sig = torch.sigmoid(i_gate.float())             # stabilized input gate
    return q, k, v, i_sig, log_f


def _mlstm_read(y_aug):
    """Split [C-readout | normalizer] and normalize."""
    y, norm = y_aug[..., :-1], y_aug[..., -1:]
    return y / torch.clamp(torch.abs(norm), min=1.0)


def _mlstm_in(x, p, cfg: ModelConfig):
    """(q, k, v', log_f, z): the gated inputs of the recurrence, v' the
    values with the normalizer's column of ones, scaled by the input gate
    (float32, as the reference's promotion makes it)."""
    cd = cfg.compute_dtype
    di, nh, hd = xlstm_dims(cfg)
    xi, z = torch.chunk(torch.matmul(x, p["in_proj"].to(cd)), 2, dim=-1)
    q, k, v, i_sig, log_f = _mlstm_qkvg(xi, p, nh, hd)
    ones = torch.ones((*v.shape[:-1], 1), dtype=v.dtype, device=v.device)
    v_aug = torch.cat([v, ones], dim=-1) * i_sig[..., None]
    return q, k, v_aug, log_f, z


def _mlstm_out(y_aug, z, p, cfg: ModelConfig):
    cd = cfg.compute_dtype
    B, S = y_aug.shape[:2]
    y = _mlstm_read(y_aug).reshape(B, S, -1).to(cd) * F.silu(z)
    return torch.matmul(y, p["out_proj"].to(cd))


def mlstm_train(x, p, cfg: ModelConfig, state: MLSTMState | None = None):
    """x (B, S, D) -> (B, S, D); with ``state``, the recurrence starts from
    it and its final value is written into it, in place."""
    q, k, v_aug, log_f, z = _mlstm_in(x, p, cfg)
    y_aug, h_last = ssd_chunked(q, k, v_aug, log_f, cfg.attn_chunk or 256,
                                h0=None if state is None else state.h)
    if state is not None:
        state.h.copy_(h_last)
    return _mlstm_out(y_aug, z, p, cfg)


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> MLSTMState:
    di, nh, hd = xlstm_dims(cfg)
    return MLSTMState(h=torch.zeros((batch, nh, hd, hd + 1), dtype=torch.float32,
                                    device=device))


def mlstm_decode(x, p, cfg: ModelConfig, state: MLSTMState):
    """One token, x (B, 1, D); ``state`` is updated in place."""
    q, k, v_aug, log_f, z = _mlstm_in(x, p, cfg)
    y_aug, h_new = ssd_step(q[:, 0], k[:, 0], v_aug[:, 0], log_f[:, 0], state.h)
    state.h.copy_(h_new)
    return _mlstm_out(y_aug[:, None], z, p, cfg), state


# ---------------------------------------------------------------------------
# sLSTM (sequential, exponential gating with stabilizer)
# ---------------------------------------------------------------------------

def init_slstm(generator, cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    di, nh, hd = xlstm_dims(cfg)
    pd = cfg.param_dtype
    return {
        "w_in": init_dense(generator, (d, nh, 4 * hd), pd, device, fan_in=d),
        "r_in": init_dense(generator, (nh, hd, 4 * hd), pd, device, fan_in=hd),
        "bias": torch.zeros((nh, 4 * hd), dtype=pd, device=device),
        "out_proj": init_dense(generator, (di, d), pd, device, fan_in=di),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> SLSTMState:
    di, nh, hd = xlstm_dims(cfg)

    def z():
        return torch.zeros((batch, nh, hd), dtype=torch.float32, device=device)

    return SLSTMState(c=z(), n=z(), m=z() - 1e9, y=z())


def _slstm_cell(r_in, bias, x_proj_t, st: SLSTMState) -> SLSTMState:
    """One sLSTM step: x_proj_t (B, nh, 4*hd), the input product computed
    outside the loop; ``r_in`` and ``bias`` in float32.  Returns the new
    state, whose ``y`` is the step's output."""
    pre = x_proj_t + torch.einsum("bhj,hjk->bhk", st.y, r_in) + bias   # (B, nh, 4*hd)
    zi, ii, fi, oi = torch.chunk(pre, 4, dim=-1)
    z_t = torch.tanh(zi)
    o_t = torch.sigmoid(oi)
    log_f = F.logsigmoid(fi)
    m_new = torch.maximum(log_f + st.m, ii)
    i_p = torch.exp(ii - m_new)
    f_p = torch.exp(log_f + st.m - m_new)
    c_new = f_p * st.c + i_p * z_t
    n_new = f_p * st.n + i_p
    y_new = o_t * c_new / torch.clamp(torch.abs(n_new), min=1.0)
    return SLSTMState(c=c_new, n=n_new, m=m_new, y=y_new)


def _slstm_proj(x, p):
    """The hoisted input product, in float32: (B, S, nh, 4*hd)."""
    return _project(x.float(), p["w_in"].float())


def slstm_train(x, p, cfg: ModelConfig, state: SLSTMState | None = None):
    """The loop over time, x (B, S, D) -> (B, S, D); with ``state``, the loop
    starts from it and its final value is written into it, in place."""
    cd = cfg.compute_dtype
    B, S, _ = x.shape
    st = state if state is not None else init_slstm_state(cfg, B, x.device)
    x_proj = _slstm_proj(x, p)
    r_in, bias = p["r_in"].float(), p["bias"].float()
    ys = []
    for t in range(S):
        st = _slstm_cell(r_in, bias, x_proj[:, t], st)
        ys.append(st.y)
    if state is not None:
        for dst, src in zip(state, st):
            dst.copy_(src)
    y = torch.stack(ys, dim=1).reshape(B, S, -1).to(cd)
    return torch.matmul(y, p["out_proj"].to(cd))


def slstm_decode(x, p, cfg: ModelConfig, state: SLSTMState):
    """One token, x (B, 1, D); ``state`` is updated in place."""
    cd = cfg.compute_dtype
    B = x.shape[0]
    st = _slstm_cell(p["r_in"].float(), p["bias"].float(), _slstm_proj(x, p)[:, 0], state)
    for dst, src in zip(state, st):
        dst.copy_(src)
    return torch.matmul(st.y.reshape(B, 1, -1).to(cd), p["out_proj"].to(cd)), state
