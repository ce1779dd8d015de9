"""Elementary model layers: norms, embeddings, rotary, MLPs.

The port of ``repro.models.layers``.  Parameters are plain dicts of
tensors.  The reference's inits split a ``jax.random`` key; here every
``init_*`` draws from an explicit ``torch.Generator`` in a fixed order, on
the generator's device, and puts the result on ``device``.  The two
packages therefore draw different weights from one seed:
:func:`repro_torch.convert.lm_params_from_numpy` carries the reference's
across where both must compute the same thing.  On ``DTensor`` s (a step
builder's sharded step) the products run as Megatron lays them out
(:func:`~repro_torch.distributed.ctx.mesh_matmul`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.ctx import (
    from_block,
    gather_sequence,
    is_dtensor,
    local_block,
    local_offset,
    mesh_cols,
    mesh_embed,
    mesh_matmul,
    model_split,
)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def init_rms_norm(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor, compute_dtype) -> torch.Tensor:
    if is_dtensor(table):
        return mesh_embed(tokens, table, compute_dtype)
    return table[tokens].to(compute_dtype)


def _normal(generator: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """Normals at ``std``, drawn in float32 on the generator's device, then
    cast and moved, as the reference scales before it casts.  On the meta
    device nothing is drawn (``generator`` may be None): the shape alone."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, device=generator.device) * std
    return x.to(device=device, dtype=dtype)


def init_embedding(generator, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return _normal(generator, (vocab, d), 0.02, dtype, device)


def unembed_layout(table):
    """A ``DTensor`` token table (V, D) as :func:`unembed`'s product takes
    it: in float32, gathered over the data axes, its rows over ``"model"``
    where they divide it (so that the chunks of a loss share one gather)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = table.device_mesh
    split = model_split(table.shape[0])
    return table.float().redistribute(mesh, [
        Shard(0) if split and name == "model" else Replicate() for name in mesh.mesh_dim_names])


def unembed(x: torch.Tensor, table: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """Project to vocab logits; table is (V, D) (tied) — computed in fp32
    (never TF32: the caller keeps ``torch.backends.cuda.matmul.allow_tf32``
    off, its default)."""
    if is_dtensor(x):
        # vocab-parallel where the vocabulary divides "model"; else in the
        # table's stored layout or with it gathered, whichever moves less
        logits = (mesh_matmul(x.float(), table.float().t(), "cols") if model_split(table.shape[0])
                  else mesh_cols(x.float(), table.float().t()))
    else:
        logits = torch.matmul(x.float(), table.float().t())
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Interleaved-pair rotary embedding, in float32.  x: (B, S, H, hd),
    positions (B, S).  The pair (2i, 2i+1) rotates by positions * freq_i."""
    if is_dtensor(x):
        # on each rank's block, at its rows' positions
        local = local_block(x, x.placements, x.placements)
        b0, s0 = local_offset(x, 0), local_offset(x, 1)
        pos = positions.full_tensor() if is_dtensor(positions) else positions
        pos = pos[b0:b0 + local.shape[0], s0:s0 + local.shape[1]]
        return from_block(apply_rope(local, pos, theta), x.device_mesh, x.placements, x.shape)
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                # (hd/2,)
    angles = positions[..., None].float() * freqs                # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xr = x.float().reshape(*x.shape[:-1], hd // 2, 2)
    x1, x2 = xr[..., 0], xr[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp(generator, d: int, f: int, dtype, device) -> dict:
    s_in = d ** -0.5
    s_out = f ** -0.5
    return {
        "wi": _normal(generator, (d, f), s_in, dtype, device),
        "wg": _normal(generator, (d, f), s_in, dtype, device),
        "wo": _normal(generator, (f, d), s_out, dtype, device),
    }


def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    """SiLU, or GELU in the tanh form (``jax.nn.gelu``'s default)."""
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def mlp(x: torch.Tensor, p: dict, act: str, compute_dtype) -> torch.Tensor:
    """On ``DTensor`` s a Megatron MLP: the hidden features over
    ``"model"`` where they divide it, the output's partial sums reduced
    (under sequence parallelism: ``x`` gathered once for both products, the
    output reduce-scattered onto the sequence; without a split, every
    product on each rank's own rows)."""
    wi = p["wi"].to(compute_dtype)
    wg = p["wg"].to(compute_dtype)
    wo = p["wo"].to(compute_dtype)
    if is_dtensor(x):
        split = model_split(wi.shape[1])
        if split:
            x = gather_sequence(x)
        h = mesh_matmul(x, wi, "cols" if split else None, seq=True)
        g = activation(mesh_matmul(x, wg, "cols" if split else None, seq=True), act)
        return mesh_matmul(h * g, wo, "rows" if split else None, seq=True)
    h = torch.matmul(x, wi)
    g = activation(torch.matmul(x, wg), act)
    return torch.matmul(h * g, wo)


def init_dense(generator, shape: tuple[int, ...], dtype, device,
               fan_in: int | None = None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    return _normal(generator, shape, fan ** -0.5, dtype, device)
