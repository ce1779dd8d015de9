"""Per-layer blocks of the decoder-only families: dense, vlm, moe, hybrid,
ssm.

The port of ``repro.models.blocks``.  Each family provides:

  * ``init_layer(generator, cfg, device)`` — one layer's parameter dict,
  * ``layer_train(p, cfg, x, positions, flag)``   -> (x, aux_loss),
  * ``layer_prefill(p, cfg, x, positions, cache, flag)`` -> (x, cache),
  * ``layer_decode(p, cfg, x, cur_len, cache, flag)``    -> (x, cache),
  * ``init_layer_cache(cfg, batch, s_max, device)`` — one layer's cache.

The reference stacks its layers on a leading axis for ``lax.scan``; the
port keeps a list of per-layer dicts and loops over it, and a layer's
cache is updated in place.  ``flag`` is the layer's entry of
:func:`layer_flags` (xLSTM: whether it is an sLSTM layer; every xLSTM
layer holds both parameter sets and both states, as the reference's
stacked layers do).  A vlm layer is a dense one: its image tokens reach it
as embeddings fused in front of the text (:mod:`.transformer`).  The
encoder-decoder's layers are :mod:`.encdec`'s.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..distributed.ctx import constrain_tokens_3d
from . import xlstm as xl
from .attention import (
    attention_train,
    decode_attention,
    init_attention,
    init_kv_cache,
    prefill_attention,
)
from .layers import init_mlp, init_rms_norm, mlp, rms_norm
from .moe import init_moe, moe_layer
from .ssm import init_ssm, init_ssm_state, ssm_decode, ssm_prefill, ssm_train

def attn_window(cfg: ModelConfig) -> int:
    return cfg.window if cfg.family == "hybrid" else 0


def layer_flags(cfg: ModelConfig) -> list[bool]:
    """Per-layer flags (xLSTM: is_slstm)."""
    if cfg.family == "ssm" and cfg.slstm_every > 0:
        return [(i + 1) % cfg.slstm_every == 0 for i in range(cfg.n_layers)]
    return [False] * cfg.n_layers


def init_layer(generator, cfg: ModelConfig, device) -> dict:
    d, fam = cfg.d_model, cfg.family
    p: dict = {"ln1": init_rms_norm(d, cfg.param_dtype, device)}
    if fam in ("dense", "vlm", "moe", "hybrid"):
        p["attn"] = init_attention(generator, cfg, device)
        p["ln2"] = init_rms_norm(d, cfg.param_dtype, device)
    if fam in ("dense", "vlm", "hybrid"):
        p["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.param_dtype, device)
    if fam == "moe":
        p["moe"] = init_moe(generator, cfg, device)
    if fam == "hybrid":
        p["ssm"] = init_ssm(generator, cfg, device)
    if fam == "ssm":            # xLSTM: dual parameter sets, the flag picks one
        p["mlstm"] = xl.init_mlstm(generator, cfg, device)
        p["slstm"] = xl.init_slstm(generator, cfg, device)
    return p


def _ffn(p: dict, cfg: ModelConfig, x):
    """The second half of an attention layer: the MLP, or the MoE layer
    (with its aux loss)."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe_layer(h, p["moe"], cfg)
        return x + y, aux
    return x + mlp(h, p["mlp"], cfg.act, cfg.compute_dtype), None


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def layer_train(p: dict, cfg: ModelConfig, x, positions, flag: bool = False,
                kernel: bool = True):
    x = constrain_tokens_3d(x)   # anchor per-layer activation sharding
    fam = cfg.family
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if fam == "ssm":
        y = (xl.slstm_train(h, p["slstm"], cfg) if flag
             else xl.mlstm_train(h, p["mlstm"], cfg))
        return x + y, _zero(x)
    x = x + attention_train(h, p["attn"], cfg, positions, window=attn_window(cfg),
                            kernel=kernel)
    if fam == "hybrid":
        x = x + ssm_train(h, p["ssm"], cfg)
    x, aux = _ffn(p, cfg, x)
    return x, _zero(x) if aux is None else aux


def init_layer_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> dict:
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return {"kv": init_kv_cache(cfg, batch, s_max, device)}
    if fam == "hybrid":
        w = min(cfg.window, s_max) if cfg.window else s_max
        return {"kv": init_kv_cache(cfg, batch, w, device),
                "ssm": init_ssm_state(cfg, batch, device)}
    return {"mlstm": xl.init_mlstm_state(cfg, batch, device),
            "slstm": xl.init_slstm_state(cfg, batch, device)}


def layer_prefill(p: dict, cfg: ModelConfig, x, positions, cache, flag: bool = False,
                  kernel: bool = True):
    x = constrain_tokens_3d(x)   # anchor per-layer activation sharding
    fam = cfg.family
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if fam == "ssm":
        y = (xl.slstm_train(h, p["slstm"], cfg, state=cache["slstm"]) if flag
             else xl.mlstm_train(h, p["mlstm"], cfg, state=cache["mlstm"]))
        return x + y, cache
    att, _ = prefill_attention(h, p["attn"], cfg, positions, cache["kv"],
                               window=attn_window(cfg), kernel=kernel)
    x = x + att
    if fam == "hybrid":     # attention and SSM read the same normed input
        x = x + ssm_prefill(h, p["ssm"], cfg, cache["ssm"])[0]
    return _ffn(p, cfg, x)[0], cache


def layer_decode(p: dict, cfg: ModelConfig, x, cur_len, cache, flag: bool = False,
                 kernel: bool = True):
    x = constrain_tokens_3d(x)   # anchor per-layer activation sharding
    fam = cfg.family
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if fam == "ssm":
        y = (xl.slstm_decode(h, p["slstm"], cfg, cache["slstm"]) if flag
             else xl.mlstm_decode(h, p["mlstm"], cfg, cache["mlstm"]))[0]
        return x + y, cache
    att, _ = decode_attention(h, p["attn"], cfg, cache["kv"], cur_len,
                              window=attn_window(cfg), kernel=kernel)
    x = x + att
    if fam == "hybrid":
        x = x + ssm_decode(h, p["ssm"], cfg, cache["ssm"])[0]
    return _ffn(p, cfg, x)[0], cache
