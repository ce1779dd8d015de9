"""Model facade: the reference's uniform API, over the families ported so
far (the dense one).

  init_params(cfg, generator, device)   -> parameter dict
  logits_fn(params, cfg, batch)         -> (B, S, V) float32 logits
  prefill_fn(params, cfg, batch, cache) -> (logits, cache)
  decode_fn(params, cfg, token, cur_len, cache) -> (logits, cache)
  init_cache(cfg, batch, s_max, device)  -> cache
  param_count(cfg)                      -> parameters, without allocating

The port of ``repro.models.model_zoo``.  The functions that allocate take a
``device`` that defaults to ``"cuda"`` and raises where CUDA is absent;
the rest run where their tensors are.  On the card, prefill and the full
forward run kernel K3 in every layer and a decode step K4; ``kernel=False``
selects the reference's einsum path there, as the kernels' oracle.  The
encoder-decoder branches raise ``NotImplementedError``, as the other
non-dense families do; ``loss_fn`` waits for the training slice and
``abstract_*`` and ``input_specs`` for the dry-run launcher (ROADMAP.md,
Queue 1 items 11 and 12).
"""
from __future__ import annotations

from typing import Any

from ..configs.base import ModelConfig
from ..core.provision import _resolve_device
from . import transformer
from .blocks import require_dense


def init_params(cfg: ModelConfig, generator, device="cuda") -> Any:
    """Random weights from ``generator`` (a ``torch.Generator``; one on the
    card draws a full-width model in well under a second)."""
    return transformer.init_lm_params(generator, cfg, _resolve_device(device, "init_params"))


def logits_fn(params, cfg: ModelConfig, batch: dict, kernel: bool = True):
    return transformer.lm_logits(params, cfg, batch, kernel=kernel)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device="cuda"):
    """The decode cache of ``s_max`` slots (the reference's ``src_len`` is
    the encoder-decoder's source length: that route is not ported)."""
    return transformer.init_lm_cache(cfg, batch, s_max, _resolve_device(device, "init_cache"))


def prefill_fn(params, cfg: ModelConfig, batch: dict, cache, kernel: bool = True):
    return transformer.lm_prefill(params, cfg, batch, cache, kernel=kernel)


def decode_fn(params, cfg: ModelConfig, token, cur_len, cache, kernel: bool = True):
    return transformer.lm_decode_step(params, cfg, token, cur_len, cache, kernel=kernel)


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``init_params(cfg, ...)``, from the shapes alone."""
    require_dense(cfg)
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = 2 * d + d * (h + 2 * kvh) * hd + h * hd * d + 3 * d * cfg.d_ff
    tables = (1 if cfg.tie_embeddings else 2) * cfg.vocab_size * d
    return tables + cfg.n_layers * layer + d
