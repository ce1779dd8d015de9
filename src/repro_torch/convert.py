"""Carry the reference's state across to the port.

The provisioning system's parameters are the cost model and the random
tables its randomized policies and prediction noise consume; the serving
engines' are the LM weights, and the trainer's the weights, the AdamW
state and the token batches.  These helpers take them as numpy arrays —
extracted from the JAX objects by the caller, since this package never
imports ``repro`` or ``jax`` — and build the port's objects, so the same
inputs drive both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.costs import CostModel
from .core.provision import _resolve_device
from .optim import AdamWState


def cost_model_from_numpy(P, beta_on, beta_off, group_sizes=None,
                          group_names=None) -> CostModel:
    """A :class:`CostModel` from the reference's fields: each a scalar or an
    ``(n_levels,)`` array.  Scalars become python floats and arrays keep
    their dtype, as the reference holds them, so Δ derives identically."""

    def field(v):
        return float(v) if np.ndim(v) == 0 else np.array(v)

    return CostModel(
        P=field(P), beta_on=field(beta_on), beta_off=field(beta_off),
        group_sizes=None if group_sizes is None else tuple(int(s) for s in group_sizes),
        group_names=None if group_names is None else tuple(str(n) for n in group_names),
    )


def uniforms_from_numpy(u0, u, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's two wait-uniform tables, (B, T, N) or (T, N), as the
    float32 tensors ``PolicySpec(uniforms=...)`` takes, on ``device``
    (``"cuda"`` unless given ``"cpu"``, as every helper here)."""
    device = _resolve_device(device, "uniforms_from_numpy")
    return tuple(
        torch.as_tensor(np.array(x, np.float32), device=device) for x in (u0, u)
    )


def normals_from_numpy(z, device="cuda") -> torch.Tensor:
    """The reference's prediction-noise normals, (T,) or (B, T), as the
    float32 tensor ``PredictionNoise(normals=...)`` takes."""
    device = _resolve_device(device, "normals_from_numpy")
    return torch.as_tensor(np.array(z, np.float32), device=device)


def carry_from_numpy(r, on, wait, device="cuda") -> dict[str, torch.Tensor]:
    """The reference streaming scan's carry — its ``{"r", "on", "wait"}``
    (G, N) arrays — as the dict the port's ``provision_scan_stream(carry=)``
    takes, so chained calls can be held to the reference."""
    device = _resolve_device(device, "carry_from_numpy")
    return {
        "r": torch.as_tensor(np.array(r, np.float32), device=device),
        "on": torch.as_tensor(np.array(on, bool), device=device),
        "wait": torch.as_tensor(np.array(wait, np.float32), device=device),
    }


def lm_params_from_numpy(params, cfg, device="cuda") -> dict:
    """The port's model parameter dict from the reference's tree as numpy
    (``jax.tree.map(np.asarray, params)``): nested dicts whose ``blocks``
    hold every layer stacked on axis 0 (the reference's ``jax.vmap``'d
    init), whatever the family's layer holds (``attn``, ``mlp``, ``moe``
    with its experts stacked on their own axis, ``ssm``, xLSTM's ``mlstm``
    and ``slstm``), with the vlm's ``frontend_proj`` beside them; for the
    encoder-decoder, ``encoder`` and ``decoder`` stacked in the same way
    (each decoder layer with its ``xattn``).  The port keeps a list of
    per-layer dicts for each stack; each tensor keeps its array's dtype and
    goes to ``device`` (``"cuda"`` unless given ``"cpu"``)."""
    return _layer_tree(params, cfg, _resolve_device(device, "lm_params_from_numpy"))


def _stacks(cfg) -> dict[str, int]:
    """The reference's stacked-layer keys of ``cfg``'s tree, with their depths."""
    if cfg.is_encdec:
        return {"encoder": cfg.n_enc_layers, "decoder": cfg.n_dec_layers}
    return {"blocks": cfg.n_layers}


def _layer_tree(params, cfg, dev) -> dict:
    """The reference's stacked-layer tree as the port's lists of layers."""

    def tensor(a):
        return torch.as_tensor(np.array(a), device=dev)

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else tensor(v[i]) for k, v in tree.items()}

    stacks = _stacks(cfg)
    out = {k: tensor(v) for k, v in params.items() if k not in stacks}
    for name, depth in stacks.items():
        out[name] = [layer(params[name], i) for i in range(depth)]
    return out


def adamw_state_from_numpy(step, m, v, cfg, device="cuda"):
    """The port's :class:`~repro_torch.optim.AdamWState` from the
    reference's (``jax.tree.map(np.asarray, state)``): ``step`` as an int32
    scalar and the moment trees ``m`` and ``v``, laid out as
    :func:`lm_params_from_numpy` lays out the parameters, so a trainer can
    go on from the reference's exact state."""
    dev = _resolve_device(device, "adamw_state_from_numpy")
    return AdamWState(step=torch.as_tensor(np.array(step, np.int32), device=dev),
                      m=_layer_tree(m, cfg, dev), v=_layer_tree(v, cfg, dev))


def token_batch_from_numpy(batch, device="cuda") -> dict:
    """A batch of the reference's ``TokenPipeline`` (a dict of arrays:
    int32 ``tokens``, bf16 ``frontend`` for the modality stubs) as tensors
    of the same dtypes on ``device``."""
    dev = _resolve_device(device, "token_batch_from_numpy")

    def tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":      # exact: every bf16 value is a float32
            return torch.as_tensor(a.astype(np.float32), device=dev).to(torch.bfloat16)
        return torch.as_tensor(np.array(a), device=dev)

    return {k: tensor(v) for k, v in batch.items()}
