"""Decoder-only LM of the dense family: init, forward and serving.

The port of ``repro.models.transformer``.  The reference scans a stacked
layer tree; here ``params["blocks"]`` is a list of per-layer dicts and the
forward is a Python loop over it (the reference's ``remat`` has no effect
without a backward pass and is left out).  The decode cache keeps the
reference's layout, ``{"kv": KVCache}`` with the layer axis leading, and
each layer updates its slice in place.  ``lm_loss`` waits for the
training slice (ROADMAP.md, Queue 1 item 11).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .attention import KVCache
from .blocks import (
    init_layer,
    init_layer_cache,
    layer_decode,
    layer_prefill,
    layer_train,
    require_dense,
)
from .layers import embed_tokens, init_embedding, init_rms_norm, rms_norm, unembed


def init_lm_params(generator, cfg: ModelConfig, device) -> dict:
    require_dense(cfg)
    p = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, cfg.param_dtype,
                                device),
        "blocks": [init_layer(generator, cfg, device) for _ in range(cfg.n_layers)],
        "final_ln": init_rms_norm(cfg.d_model, cfg.param_dtype, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                      cfg.param_dtype, device)
    return p


def _unembed_table(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def _embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Token embeddings.  The modality stubs (``frontend``) belong to the
    vlm and audio families, which are not ported."""
    require_dense(cfg)
    return embed_tokens(batch["tokens"], params["embed"], cfg.compute_dtype)


def _positions(batch: int, seq: int, device) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device).expand(batch, seq)


def lm_backbone(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                kernel: bool = True):
    """Run the layer stack; returns (final-normed hidden states, total aux
    loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params["blocks"]:
        x, a = layer_train(p, cfg, x, positions, kernel=kernel)
        aux = aux + a
    return rms_norm(x, params["final_ln"], cfg.norm_eps), aux


def lm_logits(params, cfg: ModelConfig, batch: dict, kernel: bool = True) -> torch.Tensor:
    """Full logits (small configs / tests only)."""
    x = _embed_inputs(params, cfg, batch)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    h, _ = lm_backbone(params, cfg, x, positions, kernel=kernel)
    return unembed(h, _unembed_table(params, cfg), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_lm_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> dict:
    """``{"kv": KVCache}`` with k, v (L, B, s_max, KVH, hd) and pos (L,
    s_max), as the reference stacks its layer caches."""
    caches = [init_layer_cache(cfg, batch, s_max, device)["kv"] for _ in range(cfg.n_layers)]
    return {"kv": KVCache(*(torch.stack(xs) for xs in zip(*caches)))}


def _layer_cache(cache: dict, i: int) -> dict:
    """Layer ``i``'s cache as views into the stacked one."""
    kv = cache["kv"]
    return {"kv": KVCache(kv.k[i], kv.v[i], kv.pos[i])}


def lm_prefill(params, cfg: ModelConfig, batch: dict, cache: dict, kernel: bool = True):
    """Returns (last-position logits, the cache filled in place)."""
    x = _embed_inputs(params, cfg, batch)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for i, p in enumerate(params["blocks"]):
        x, _ = layer_prefill(p, cfg, x, positions, _layer_cache(cache, i), kernel=kernel)
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = unembed(h[:, -1:, :], _unembed_table(params, cfg), cfg.logit_softcap)
    return logits[:, 0, :], cache


def lm_decode_step(params, cfg: ModelConfig, token: torch.Tensor, cur_len, cache: dict,
                   kernel: bool = True):
    """token: (B,) int; cur_len: int (tokens already cached).  Returns (logits,
    the cache updated in place)."""
    x = embed_tokens(token[:, None], params["embed"], cfg.compute_dtype)
    cur_len = int(cur_len)
    for i, p in enumerate(params["blocks"]):
        x, _ = layer_decode(p, cfg, x, cur_len, _layer_cache(cache, i), kernel=kernel)
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = unembed(h[:, -1:, :], _unembed_table(params, cfg), cfg.logit_softcap)
    return logits[:, 0, :], cache
