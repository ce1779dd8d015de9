"""Carry the reference's state across to the port.

The provisioning system's parameters are the cost model and the random
tables its randomized policies and prediction noise consume; the serving
engines' are the LM weights.  These helpers take them as numpy arrays —
extracted from the JAX objects by the caller, since this package never
imports ``repro`` or ``jax`` — and build the port's objects, so the same
inputs drive both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.costs import CostModel
from .core.provision import _resolve_device
from .models.blocks import require_dense


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


def uniforms_from_numpy(u0, u, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's two wait-uniform tables, (B, T, N) or (T, N), as the
    float32 tensors ``PolicySpec(uniforms=...)`` takes."""
    return tuple(
        torch.as_tensor(np.array(x, np.float32), device=device) for x in (u0, u)
    )


def normals_from_numpy(z, device="cpu") -> torch.Tensor:
    """The reference's prediction-noise normals, (T,) or (B, T), as the
    float32 tensor ``PredictionNoise(normals=...)`` takes."""
    return torch.as_tensor(np.array(z, np.float32), device=device)


def carry_from_numpy(r, on, wait, device="cpu") -> dict[str, torch.Tensor]:
    """The reference streaming scan's carry — its ``{"r", "on", "wait"}``
    (G, N) arrays — as the dict the port's ``provision_scan_stream(carry=)``
    takes, so chained calls can be held to the reference."""
    return {
        "r": torch.as_tensor(np.array(r, np.float32), device=device),
        "on": torch.as_tensor(np.array(on, bool), device=device),
        "wait": torch.as_tensor(np.array(wait, np.float32), device=device),
    }


def lm_params_from_numpy(params, cfg, device="cuda") -> dict:
    """The port's LM parameter dict from the reference's tree as numpy
    (``jax.tree.map(np.asarray, params)``): nested dicts whose ``blocks``
    hold every layer stacked on axis 0 (the reference's ``jax.vmap``'d
    init).  The port keeps a list of per-layer dicts; each tensor keeps its
    array's dtype and goes to ``device`` (``"cuda"`` unless given
    ``"cpu"``)."""
    require_dense(cfg)
    dev = _resolve_device(device, "lm_params_from_numpy")

    def tensor(a):
        return torch.as_tensor(np.array(a), device=dev)

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else tensor(v[i]) for k, v in tree.items()}

    out = {k: tensor(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [layer(params["blocks"], i) for i in range(cfg.n_layers)]
    return out
