"""Model facade: the reference's uniform API over all ten architectures
(dense, vlm, moe, hybrid, ssm, and the encoder-decoder).

  init_params(cfg, generator, device)   -> parameter dict
  init_served_params(cfg, generator, device) -> the served tree, drawn leaf
                                        by leaf (matrices in the compute dtype)
  loss_fn(params, cfg, batch)           -> (loss, metrics)
  logits_fn(params, cfg, batch)         -> (B, S, V) float32 logits
  prefill_fn(params, cfg, batch, cache) -> (logits, cache)
  decode_fn(params, cfg, token, cur_len, cache) -> (logits, cache)
  init_cache(cfg, batch, s_max, src_len, device) -> cache
  abstract_params(cfg) / abstract_cache(cfg, shape) -> the same on the meta
                                        device (shapes and dtypes, nothing
                                        allocated)
  input_specs(cfg, shape)               -> one cell's inputs, on meta
  param_count(cfg)                      -> parameters, without allocating
  served_param_bytes(cfg)               -> the served tree's bytes, the same
  embedding_param_count(cfg)            -> of which in the token tables
  active_param_count(cfg)               -> per token (MoE: top_k of n_experts)

The port of ``repro.models.model_zoo``.  The functions that allocate take a
``device`` that defaults to ``"cuda"`` and raises where CUDA is absent;
the rest run where their tensors are.  On the card, prefill and the full
forward run kernel K3 in every layer and a decode step K4; ``kernel=False``
selects the reference's einsum path there, as the kernels' oracle, and is
the path to differentiate: the kernels are forward-only, so ``loss_fn``
with grad enabled on parameters that require grad raises on the card
unless given ``kernel=False`` (the trainer's step).  The vlm and audio
families take the modality stub's embeddings as ``batch["frontend"]``;
``cfg.is_encdec`` (seamless-m4t) routes every entry point to
:mod:`.encdec`.  ``device="meta"`` builds the parameters or the cache as
meta tensors, the counterpart of the reference's ``jax.eval_shape``: the
sharding rules and the dry-run plan from their shapes alone.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig, ShapeCell
from ..core.provision import _resolve_device
from . import encdec, transformer
from .layers import leaf_dtype
from .ssm import ssm_dims
from .xlstm import xlstm_dims

META = torch.device("meta")


def _model_device(device, owner: str) -> torch.device:
    """``device`` for a model build: the meta device, or one that
    ``_resolve_device`` accepts."""
    device = torch.device(device)
    return device if device.type == "meta" else _resolve_device(device, owner)


def init_params(cfg: ModelConfig, generator, device="cuda") -> Any:
    """Random weights from ``generator`` (a ``torch.Generator``; one on the
    card draws a full-width model in well under a second).  On the meta
    device ``generator`` may be None: nothing is drawn."""
    return _init(cfg, generator, _model_device(device, "init_params"), served=False)


def init_served_params(cfg: ModelConfig, generator, device="cuda") -> Any:
    """The served tree: ``serving_params(init_params(cfg, generator), cfg,
    device)`` bit for bit (the same float32 draws in the same order), but
    each leaf cast to its served dtype (:func:`.layers.leaf_dtype`) as soon
    as it is drawn, so the float32 tree never exists: the peak is the
    served tree plus one leaf's float32 draw.  The entry point of a model
    whose float32 tree does not fit on the card."""
    return _init(cfg, generator, _model_device(device, "init_served_params"), served=True)


def _init(cfg: ModelConfig, generator, device: torch.device, served: bool) -> Any:
    if cfg.is_encdec:
        return encdec.init_encdec_params(generator, cfg, device, served)
    return transformer.init_lm_params(generator, cfg, device, served)


def loss_fn(params, cfg: ModelConfig, batch: dict, kernel: bool = True):
    if cfg.is_encdec:
        return encdec.encdec_loss(params, cfg, batch, kernel=kernel)
    return transformer.lm_loss(params, cfg, batch, kernel=kernel)


def logits_fn(params, cfg: ModelConfig, batch: dict, kernel: bool = True):
    """(B, S, V) float32 logits; the encoder-decoder's unembed with
    ``params["embed"]``, its one token table."""
    if cfg.is_encdec:
        return encdec.encdec_logits(params, cfg, batch, kernel=kernel)
    return transformer.lm_logits(params, cfg, batch, kernel=kernel)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, src_len: int = 0, device="cuda"):
    """The decode cache of ``s_max`` slots; the encoder-decoder's also holds
    the cross K/V of ``src_len`` source frames (4096 when 0, as in the
    reference)."""
    device = _model_device(device, "init_cache")
    if cfg.is_encdec:
        return encdec.init_encdec_cache(cfg, batch, s_max, src_len or 4096, device)
    return transformer.init_lm_cache(cfg, batch, s_max, device)


def prefill_fn(params, cfg: ModelConfig, batch: dict, cache, kernel: bool = True):
    if cfg.is_encdec:
        return encdec.encdec_prefill(params, cfg, batch, cache, kernel=kernel)
    return transformer.lm_prefill(params, cfg, batch, cache, kernel=kernel)


def decode_fn(params, cfg: ModelConfig, token, cur_len, cache, kernel: bool = True):
    if cfg.is_encdec:
        return encdec.encdec_decode_step(params, cfg, token, cur_len, cache, kernel=kernel)
    return transformer.lm_decode_step(params, cfg, token, cur_len, cache, kernel=kernel)


def abstract_params(cfg: ModelConfig) -> Any:
    """The parameter tree as meta tensors: shapes and dtypes, no storage
    (the dry-run path)."""
    return init_params(cfg, None, META)


def param_leaves(tree, name: str | None = None):
    """(name, tensor) of every leaf of a parameter tree (or a cache), in the
    tree's order; a leaf's name is its dict key (the layers' lists and a
    cache's named tuples pass theirs)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from param_leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from param_leaves(v, name)
    else:
        yield name, tree


def served_param_bytes(cfg: ModelConfig) -> int:
    """Bytes of :func:`init_served_params`'s tree, from
    :func:`abstract_params` alone: each leaf in its served dtype."""
    return sum(x.numel() * leaf_dtype(cfg, name, True, x.dtype).itemsize
               for name, x in param_leaves(abstract_params(cfg)))


# ---------------------------------------------------------------------------
# Input specs (meta stand-ins, shardable, no device allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeCell) -> dict:
    """Abstract inputs for one (arch x shape) cell, as meta tensors.

    train:   {"tokens": (B, S)} (+ frontend embeddings for vlm/audio)
    prefill: same as train
    decode:  {"token": (B,), "cur_len": scalar}; the cache comes separately.
    """
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=META)

    if shape.kind in ("train", "prefill"):
        specs: dict = {}
        if cfg.frontend == "vision_stub":
            nf = cfg.n_frontend_tokens
            specs["tokens"] = spec((B, S - nf), i32)
            specs["frontend"] = spec((B, nf, cfg.d_model), bf16)
        elif cfg.frontend == "audio_stub":
            # enc-dec: source frames + target tokens, each of length S
            specs["tokens"] = spec((B, S), i32)
            specs["frontend"] = spec((B, encdec_src_len(cfg, shape), cfg.d_model), bf16)
        else:
            specs["tokens"] = spec((B, S), i32)
        return specs
    # decode
    return {"token": spec((B,), i32), "cur_len": spec((), i32)}


def encdec_src_len(cfg: ModelConfig, shape: ShapeCell) -> int:
    """Source frames for enc-dec cells: match S for train/prefill; decode
    uses a fixed 4096-frame memory (the 32k/500k axis is the decoder cache)."""
    if shape.kind in ("train", "prefill"):
        return shape.seq_len
    return 4096


def abstract_cache(cfg: ModelConfig, shape: ShapeCell) -> Any:
    """The decode cache of one cell as meta tensors."""
    return init_cache(cfg, shape.global_batch, shape.seq_len,
                      src_len=encdec_src_len(cfg, shape), device=META)


def _layer_param_count(cfg: ModelConfig) -> int:
    """Parameters of one layer of ``blocks.init_layer``, from the shapes."""
    d, h, kvh, hd, fam = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.family
    n = d                                                   # ln1
    if fam in ("dense", "vlm", "moe", "hybrid"):
        n += d * (h + 2 * kvh) * hd + h * hd * d + d        # attn, ln2
    if fam in ("dense", "vlm", "hybrid"):
        n += 3 * d * cfg.d_ff
    if fam == "moe":
        n += d * cfg.n_experts + 3 * cfg.n_experts * d * cfg.moe_d_ff
    if fam == "hybrid":
        di, nh = ssm_dims(cfg)
        n += (d * 2 * di + cfg.ssm_conv_width * di + di * 2 * cfg.ssm_state + di * nh
              + 3 * nh + di * d)
    if fam == "ssm":
        di, nh, xhd = xlstm_dims(cfg)
        n += d * 2 * di + 2 * di * nh * xhd + di * 2 * nh + 2 * nh + di * d      # mLSTM
        n += d * nh * 4 * xhd + nh * xhd * 4 * xhd + nh * 4 * xhd + di * d       # sLSTM
    return n


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``init_params(cfg, ...)``, from the shapes alone."""
    if cfg.is_encdec:
        return encdec.param_count(cfg)
    frontend = cfg.d_model ** 2 if cfg.frontend != "none" else 0
    return (embedding_param_count(cfg) + cfg.n_layers * _layer_param_count(cfg) + cfg.d_model
            + frontend)


def embedding_param_count(cfg: ModelConfig) -> int:
    """Parameters of the token tables (the embedding, and the unembedding
    unless tied; the encoder-decoder has the one table)."""
    tables = 1 if cfg.tie_embeddings or cfg.is_encdec else 2
    return tables * cfg.vocab_size * cfg.d_model


def active_param_count(cfg: ModelConfig) -> int:
    """Per-token active parameters: for MoE, ``top_k`` of ``n_experts``
    experts' weights (the router counts in full), by the reference's
    float arithmetic."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    expert_params = cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff
    return int(total - expert_params + expert_params * cfg.top_k / cfg.n_experts)
