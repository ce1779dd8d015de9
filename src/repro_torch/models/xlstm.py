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

**On a mesh.**  Under a step builder's sharding context the blocks run on
``DTensor`` s.  The mLSTM recurrence runs on each rank's block of its
state as the sharding rules store it (the heads over ``"model"`` where they
divide it, else whole heads on the rank's batch rows): no collective in
the recurrence and none of its state.  Its products keep the weights where
they are stored (``in_proj``'s columns and ``wq``, ``wk``, ``wif``'s and
``out_proj``'s rows over ``"model"``) and move the activations, or gather a
weight where that is the smaller thing to move
(:func:`~repro_torch.distributed.ctx.mesh_cols`,
:func:`~repro_torch.distributed.ctx.mesh_rows`): a decode step reduces
(B, di) products, never a (B, nh, hd, hd + 1) state.  The sLSTM loop mixes
a head's whole hd through ``r_in``, so it runs on whole heads (split over
``"model"`` where they divide it) of the rank's batch rows, as plain local
tensors, with ``r_in`` gathered once: the state is redistributed once
before the loop and once after it.  A decode step (one position) runs on
whole heads with ``r_in`` left in its stored column blocks: the recurrent
product is taken there and gathered ((B, nh, 4 hd), a few hundred kB).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.ctx import is_dtensor
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




def _mlstm_read(y_aug):
    """Split [C-readout | normalizer] and normalize."""
    y, norm = y_aug[..., :-1], y_aug[..., -1:]
    return y / torch.clamp(torch.abs(norm), min=1.0)


def _mlstm_in(x, p, cfg: ModelConfig):
    """(q, k, v', log_f, z): the gated inputs of the recurrence
    (:func:`_mlstm_gated`)."""
    cd = cfg.compute_dtype
    di, nh, hd = xlstm_dims(cfg)
    xi, z = torch.chunk(torch.matmul(x, p["in_proj"].to(cd)), 2, dim=-1)
    q = _project(xi, p["wq"].to(cd))
    k = _project(xi, p["wk"].to(cd)) * (hd ** -0.5)
    v = xi.reshape(*xi.shape[:2], nh, hd)
    gates = torch.matmul(xi, p["wif"].to(cd)) + p["if_bias"].to(cd)
    return _mlstm_gated(q, k, v, gates, z)


def _mlstm_out(y_aug, z, p, cfg: ModelConfig):
    cd = cfg.compute_dtype
    B, S = y_aug.shape[:2]
    y = _mlstm_read(y_aug).reshape(B, S, -1).to(cd) * F.silu(z)
    return torch.matmul(y, p["out_proj"].to(cd))


def _mlstm_gated(q, k, v, gates, z):
    """(q, k, v', log_f, z) from the projections: v' the values with the
    normalizer's column of ones, scaled by the input gate (float32, as the
    reference's promotion makes it)."""
    i_gate, f_gate = torch.chunk(gates, 2, dim=-1)    # (B, S, nh)
    log_f = F.logsigmoid(f_gate.float())
    i_sig = torch.sigmoid(i_gate.float())             # stabilized input gate
    ones = torch.ones((*v.shape[:-1], 1), dtype=v.dtype, device=v.device)
    v_aug = torch.cat([v, ones], dim=-1) * i_sig[..., None]
    return q, k, v_aug, log_f, z


def _mlstm_mesh(x, p, cfg: ModelConfig, state: MLSTMState | None = None, step: bool = False):
    """The mLSTM on ``DTensor`` s, as the module's docstring sets out: the
    full sequence (``step`` False; with ``state``, from it) or one decode
    step; the state written in place.  Returns (B, S, D), whole over
    ``"model"`` (under sequence parallelism, its sequence gathered at entry
    and the output reduce-scattered onto it)."""
    from torch.distributed.tensor import Shard

    from ..distributed.ctx import (
        block_layout,
        channels,
        gather_sequence,
        mesh_cols,
        mesh_rows,
        mine,
        model_axis_size,
        state_block,
        store_block,
        weight_part,
    )

    cd = cfg.compute_dtype
    di, nh, hd = xlstm_dims(cfg)
    x = gather_sequence(x)          # the recurrence reads the whole sequence
    mesh = x.device_mesh
    axis = 0 if nh % model_axis_size() == 0 else None
    rec = channels((nh, hd), axis)                 # this rank's heads' channels
    heads = channels((nh,), axis)
    split = len(rec) > 1
    xp, yp = block_layout(x, split)
    xi, z = torch.chunk(mesh_cols(x, p["in_proj"].to(cd)), 2, dim=-1)
    q = mesh_cols(xi, p["wq"].to(cd), rec)
    k = mesh_cols(xi, p["wk"].to(cd), rec) * (hd ** -0.5)
    both = [torch.cat([h, nh + h]) for h in heads]
    gates = mesh_cols(xi, p["wif"].to(cd), both) + weight_part(p["if_bias"].to(cd), both, yp)
    nh_l = len(heads[0])
    q, k, v = (t.unflatten(-1, (nh_l, hd)) for t in (q, k, mine(xi, rec, split)))
    q, k, v_aug, log_f, z = _mlstm_gated(q, k, v, gates, mine(z, rec, split))
    h_layout = list(xp)
    if split:
        h_layout[mesh.mesh_dim_names.index("model")] = Shard(1)
    h0 = None if state is None else state_block(state.h, h_layout)
    if step:
        y_aug, h_last = ssd_step(q[:, 0], k[:, 0], v_aug[:, 0], log_f[:, 0], h0)
        y_aug = y_aug[:, None]
    else:
        y_aug, h_last = ssd_chunked(q, k, v_aug, log_f, cfg.attn_chunk or 256, h0=h0)
    if state is not None:
        store_block(state.h, h_last, h_layout)
    y = _mlstm_read(y_aug).flatten(-2).to(cd) * F.silu(z)
    return mesh_rows(y, rec, p["out_proj"].to(cd), x, seq=True)


def mlstm_train(x, p, cfg: ModelConfig, state: MLSTMState | None = None):
    """x (B, S, D) -> (B, S, D); with ``state``, the recurrence starts from
    it and its final value is written into it, in place."""
    if is_dtensor(x):
        return _mlstm_mesh(x, p, cfg, state)
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
    if is_dtensor(x):
        return _mlstm_mesh(x, p, cfg, state, step=True), state
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


def _slstm_cell(r_in, bias, x_proj_t, st: SLSTMState, rec=None) -> SLSTMState:
    """One sLSTM step: x_proj_t (B, nh, 4*hd), the input product computed
    outside the loop; ``r_in`` and ``bias`` in float32; ``rec``, the
    recurrent product ``st.y`` x ``r_in`` where it was computed already.
    Returns the new state, whose ``y`` is the step's output."""
    if rec is None:
        rec = torch.einsum("bhj,hjk->bhk", st.y, r_in)
    pre = x_proj_t + rec + bias                       # (B, nh, 4*hd)
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


def _slstm_mesh(x, p, cfg: ModelConfig, state: SLSTMState | None = None):
    """The sLSTM on ``DTensor`` s, as the module's docstring sets out: the
    loop over x (B, S, D) on whole heads of each rank's batch rows (one
    position: a decode step); with ``state``, from it, its final value
    written in place.  Returns (B, S, D), whole over ``"model"`` (under
    sequence parallelism, its sequence gathered at entry and the output
    reduce-scattered onto it)."""
    from torch.distributed.tensor import Shard

    from ..distributed.ctx import (
        block_layout,
        channels,
        from_block,
        gather_sequence,
        local_rows,
        mesh_cols,
        mesh_rows,
        model_axis_size,
        state_block,
        store_block,
        weight_part,
    )

    cd = cfg.compute_dtype
    di, nh, hd = xlstm_dims(cfg)
    B, S, _ = x.shape
    x = gather_sequence(x)          # the loop runs over the whole sequence
    mesh = x.device_mesh
    # a step runs on whole heads, so that r_in may stay in its column blocks
    axis = 0 if S > 1 and nh % model_axis_size() == 0 else None
    heads = channels((nh,), axis)
    cols = channels((nh, 4 * hd), axis)
    split = len(heads) > 1
    xp, yp = block_layout(x, split)
    nh_l = len(heads[0])
    x_proj = mesh_cols(x.float(), p["w_in"].float(), cols).unflatten(-1, (nh_l, 4 * hd))
    bias = weight_part(p["bias"].float(), cols, yp).reshape(nh_l, 4 * hd)
    st_layout = list(xp)
    if split:
        st_layout[mesh.mesh_dim_names.index("model")] = Shard(1)
    if state is not None:
        st = SLSTMState(*(state_block(t, st_layout) for t in state))
    else:
        st = init_slstm_state(cfg, x_proj.shape[0], x_proj.device)
        st = SLSTMState(*(t[:, :nh_l] for t in st))
    r_in = p["r_in"].float()
    ys = []
    if S == 1 and local_rows(x, xp) < hd:
        # the recurrent product in r_in's own layout, then gathered
        rec = _recurrent_product(from_block(st.y, mesh, xp, (B, nh, hd)), r_in)
        ys.append(_slstm_cell(None, bias, x_proj[:, 0], st, rec=rec))
    else:
        r_in = weight_part(r_in, channels((nh, hd, 4 * hd), axis), yp).reshape(nh_l, hd, 4 * hd)
        # on meta tensors (the dry-run's trace) the body runs once for the S
        # steps, as the reference's scan is compiled and costed once
        for t in range(1 if x_proj.device.type == "meta" else S):
            ys.append(_slstm_cell(r_in, bias, x_proj[:, t], st if t == 0 else ys[-1]))
    if state is not None:
        for dst, src in zip(state, ys[-1]):
            store_block(dst, src, st_layout)
    y = torch.stack([s.y for s in ys], dim=1).expand(-1, S, -1, -1).flatten(-2).to(cd)
    return mesh_rows(y, channels((nh, hd), axis), p["out_proj"].to(cd), x, seq=True)


def _recurrent_product(y, r_in):
    """``einsum("bhj,hjk->bhk", y, r_in)`` for a ``DTensor`` ``y`` (B, nh,
    hd) whole over ``"model"`` and ``r_in`` (nh, hd, 4 hd) in its stored
    layout: computed where ``r_in`` is stored (its columns, or its rows with
    the partial sums reduced) and gathered.  Returns this rank's batch rows
    of it, a local tensor."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..distributed.ctx import block_layout, from_block, local_block, model_axis_size

    mesh = y.device_mesh
    xp, _ = block_layout(y, False)
    rp, yp, ys = [Replicate()] * mesh.ndim, list(xp), list(xp)
    if model_axis_size() > 1:
        i = mesh.mesh_dim_names.index("model")
        s = r_in.placements[i]
        if s.is_shard(2):
            rp[i] = yp[i] = Shard(2)
        elif s.is_shard(1):
            rp[i], ys[i], yp[i] = s, Shard(2), Partial()
    out = torch.einsum("bhj,hjk->bhk", local_block(y, ys, yp), local_block(r_in, rp, yp))
    out = from_block(out, mesh, yp, (*y.shape[:2], r_in.shape[2]))
    return out.redistribute(mesh, xp).to_local()


def slstm_train(x, p, cfg: ModelConfig, state: SLSTMState | None = None):
    """The loop over time, x (B, S, D) -> (B, S, D); with ``state``, the loop
    starts from it and its final value is written into it, in place."""
    if is_dtensor(x):
        return _slstm_mesh(x, p, cfg, state)
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
    if is_dtensor(x):
        return _slstm_mesh(x, p, cfg, state), state
    cd = cfg.compute_dtype
    B = x.shape[0]
    st = _slstm_cell(p["r_in"].float(), p["bias"].float(), _slstm_proj(x, p)[:, 0], state)
    for dst, src in zip(state, st):
        dst.copy_(src)
    return torch.matmul(st.y.reshape(B, 1, -1).to(cd), p["out_proj"].to(cd)), state
