"""Per-layer blocks of the dense family.

The port of the ``dense`` branch of ``repro.models.blocks``:

  * ``init_layer(generator, cfg, device)`` — one layer's parameter dict,
  * ``layer_train(p, cfg, x, positions)``   -> (x, aux_loss),
  * ``layer_prefill(p, cfg, x, positions, cache)`` -> (x, cache),
  * ``layer_decode(p, cfg, x, cur_len, cache)``    -> (x, cache),
  * ``init_layer_cache(cfg, batch, s_max, device)`` — one layer's cache.

The reference stacks its layers on a leading axis for ``lax.scan``; the
port keeps a list of per-layer dicts and loops over it.  The other
families (``moe``, ``hybrid``, ``ssm``, ``vlm``, ``audio`` and the
encoder-decoder) raise ``NotImplementedError``: they are not ported yet
(ROADMAP.md, Queue 1 item 11).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .attention import (
    attention_train,
    decode_attention,
    init_attention,
    init_kv_cache,
    prefill_attention,
)
from .layers import init_mlp, init_rms_norm, mlp, rms_norm


def require_dense(cfg: ModelConfig) -> None:
    """``NotImplementedError`` for every family but the dense one."""
    if cfg.is_encdec or cfg.family != "dense":
        kind = "the encoder-decoder route" if cfg.is_encdec else f"family {cfg.family!r}"
        raise NotImplementedError(
            f"{cfg.name}: {kind} is not ported yet; the port runs the dense family "
            "(ROADMAP.md, Queue 1 item 11)")


def init_layer(generator, cfg: ModelConfig, device) -> dict:
    require_dense(cfg)
    d = cfg.d_model
    return {
        "ln1": init_rms_norm(d, cfg.param_dtype, device),
        "attn": init_attention(generator, cfg, device),
        "ln2": init_rms_norm(d, cfg.param_dtype, device),
        "mlp": init_mlp(generator, d, cfg.d_ff, cfg.param_dtype, device),
    }


def layer_train(p: dict, cfg: ModelConfig, x, positions, kernel: bool = True):
    require_dense(cfg)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attention_train(h, p["attn"], cfg, positions, kernel=kernel)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp(h, p["mlp"], cfg.act, cfg.compute_dtype)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_layer_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> dict:
    require_dense(cfg)
    return {"kv": init_kv_cache(cfg, batch, s_max, device)}


def layer_prefill(p: dict, cfg: ModelConfig, x, positions, cache, kernel: bool = True):
    require_dense(cfg)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    att, kv = prefill_attention(h, p["attn"], cfg, positions, cache["kv"], kernel=kernel)
    x = x + att
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp(h, p["mlp"], cfg.act, cfg.compute_dtype)
    return x, {"kv": kv}


def layer_decode(p: dict, cfg: ModelConfig, x, cur_len, cache, kernel: bool = True):
    require_dense(cfg)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    att, kv = decode_attention(h, p["attn"], cfg, cache["kv"], cur_len, kernel=kernel)
    x = x + att
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp(h, p["mlp"], cfg.act, cfg.compute_dtype)
    return x, {"kv": kv}
