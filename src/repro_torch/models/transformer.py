"""Decoder-only LM of the dense, vlm, moe, hybrid and ssm families: init,
train, forward and serving.

The port of ``repro.models.transformer``.  The reference scans a stacked
layer tree; here ``params["blocks"]`` is a list of per-layer dicts and the
forward is a Python loop over it.  ``cfg.remat`` recomputes each layer in
the backward pass (``"full"``, and ``"dots"`` as ``"full"``: PyTorch has no
counterpart of JAX's save-the-matmuls policy) through
``torch.utils.checkpoint``, or not at all (``"none"``); it changes no
result.  :func:`lm_loss` streams the unembedding and the cross-entropy over
:data:`LOSS_CHUNK` positions at a time, so the (B, S, V) logits never exist
at once.  The decode cache keeps the reference's layout, ``{"kv":
KVCache}`` with the layer axis leading, and each layer updates its slice
in place.  The vlm family's image tokens are the modality stub's
embeddings, ``batch["frontend"]`` (B, n_frontend_tokens, D), projected by
``frontend_proj`` and put before the text's (early fusion): the sequence
the layers see is [image | text] at positions 0..nf+S-1, causal over
both as in the reference, and the loss scores the text alone.
The hybrid family's cache is ``{"kv": KVCache, "ssm": SSMState}`` and the
ssm (xLSTM) family's ``{"mlstm": MLSTMState, "slstm": SLSTMState}``, each
leaf stacked on a leading layer axis in the same way.

``kernel`` selects the attention route as in :mod:`repro_torch.models.
attention`: on the card K3 (prefill, the full forward, the loss) and K4
(decode), which are forward-only and raise where autograd needs them;
``kernel=False`` is the reference's einsum path, the one to differentiate.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from ..distributed.ctx import (
    constrain_tokens_3d,
    gather_sequence,
    is_dtensor,
    last_position,
    whole,
)
from .blocks import (
    init_layer,
    init_layer_cache,
    layer_decode,
    layer_flags,
    layer_prefill,
    layer_train,
)
from .layers import (
    embed_tokens,
    unembed_layout,
    init_dense,
    init_embedding,
    init_rms_norm,
    rms_norm,
    unembed,
)

#: positions per chunk of the streamed cross-entropy
LOSS_CHUNK = 512


def init_lm_params(generator, cfg: ModelConfig, device) -> dict:
    p = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, cfg.param_dtype,
                                device),
        "blocks": [init_layer(generator, cfg, device) for _ in range(cfg.n_layers)],
        "final_ln": init_rms_norm(cfg.d_model, cfg.param_dtype, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                      cfg.param_dtype, device)
    if cfg.frontend != "none":
        p["frontend_proj"] = init_dense(generator, (cfg.d_model, cfg.d_model),
                                        cfg.param_dtype, device)
    return p


def _unembed_table(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def _embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Token embeddings, with the modality stub's tokens (projected by
    ``frontend_proj``) fused at the front."""
    cd = cfg.compute_dtype
    x = embed_tokens(batch["tokens"], params["embed"], cd)
    if cfg.frontend != "none":
        fe = torch.matmul(batch["frontend"].to(cd), params["frontend_proj"].to(cd))
        x = torch.cat([fe, x], dim=1)
    return constrain_tokens_3d(x)


def _positions(batch: int, seq: int, device) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device).expand(batch, seq)


def _remat(fn, cfg: ModelConfig):
    """``fn`` recomputed in the backward pass unless ``cfg.remat`` is
    ``"none"`` (and run as it is where no gradient is being taken)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn

    def recomputed(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)

    return recomputed


def lm_backbone(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                kernel: bool = True):
    """Run the layer stack; returns (final-normed hidden states, total aux
    loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, flag in zip(params["blocks"], layer_flags(cfg)):
        x, a = _remat(lambda h, p=p, flag=flag: layer_train(p, cfg, h, positions, flag,
                                                            kernel=kernel), cfg)(x)
        aux = aux + a
    return rms_norm(x, params["final_ln"], cfg.norm_eps), aux


def _chunk_ce(h: torch.Tensor, tgt: torch.Tensor, table: torch.Tensor,
              softcap: float) -> torch.Tensor:
    """Summed next-token cross-entropy of one chunk: h (B, c, D), targets
    (B, c); the (B, c, V) float32 logits live only inside this call.  On
    ``DTensor`` s the logits stay split over the vocabulary (``"model"``)
    and the log-sum-exp and the picked logit are reduced across it, as a
    vocab-parallel loss does, instead of gathering every row."""
    logits = unembed(h, table, softcap)
    if is_dtensor(logits):
        m = whole(logits.detach().amax(dim=-1, keepdim=True))
        lse = (m + torch.log(whole(torch.exp(logits - m).sum(dim=-1, keepdim=True))))[..., 0]
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        picked = whole(torch.where(vocab == tgt[..., None].long(), logits, 0.0).sum(dim=-1))
        return torch.sum(lse - picked)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, tgt[..., None].long())[..., 0]
    return torch.sum(lse - picked)


def lm_loss(params, cfg: ModelConfig, batch: dict, kernel: bool = True):
    """Next-token CE over text positions, streamed in sequence chunks;
    returns ``(loss, {"ce", "aux"})``, the MoE aux term added at 0.01 as
    the reference adds it.  Where gradients are taken and the positions
    span several chunks, each chunk's logits are recomputed in the
    backward pass instead of kept."""
    tokens = batch["tokens"]
    B, S_text = tokens.shape
    x = _embed_inputs(params, cfg, batch)
    S_total = x.shape[1]
    h, aux = lm_backbone(params, cfg, x, _positions(B, S_total, x.device), kernel=kernel)

    # the sequence gathered once for every chunk's vocab-split product
    # (sequence parallelism); predictions for text tokens only: positions
    # offset..offset+S_text-1
    h_text = gather_sequence(h)[:, S_total - S_text:, :]
    table = _unembed_table(params, cfg)
    if is_dtensor(table):       # laid out for the products once, not once per chunk
        table = unembed_layout(table)
    n_pred = S_text - 1
    chunk = min(LOSS_CHUNK, max(n_pred, 1))
    n_chunks = -(-n_pred // chunk)                          # ceil
    ce = _chunk_ce
    if n_chunks > 1 and torch.is_grad_enabled():
        def ce(*args):
            return torch.utils.checkpoint.checkpoint(_chunk_ce, *args, use_reentrant=False)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        lo, hi = i * chunk, min((i + 1) * chunk, n_pred)
        total = total + ce(h_text[:, lo:hi], tokens[:, 1 + lo:1 + hi], table,
                           cfg.logit_softcap)
    loss = total / (B * n_pred)
    metrics = {"ce": loss, "aux": aux}
    if cfg.n_experts:
        loss = loss + 0.01 * aux
    return loss, metrics


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
    """Every layer's cache stacked on a leading layer axis, as the reference
    stacks them: for the dense and moe families ``{"kv": KVCache}`` with k,
    v (L, B, s_max, KVH, hd) and pos (L, s_max)."""
    caches = [init_layer_cache(cfg, batch, s_max, device) for _ in range(cfg.n_layers)]
    return {name: type(state)(*(torch.stack(xs) for xs in zip(*(c[name] for c in caches))))
            for name, state in caches[0].items()}


def _layer_cache(cache: dict, i: int) -> dict:
    """Layer ``i``'s cache as views into the stacked one."""
    return {name: type(state)(*(x[i] for x in state)) for name, state in cache.items()}


def lm_prefill(params, cfg: ModelConfig, batch: dict, cache: dict, kernel: bool = True):
    """Returns (last-position logits, the cache filled in place)."""
    x = _embed_inputs(params, cfg, batch)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for i, (p, flag) in enumerate(zip(params["blocks"], layer_flags(cfg))):
        x, _ = layer_prefill(p, cfg, x, positions, _layer_cache(cache, i), flag, kernel=kernel)
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = unembed(last_position(h), _unembed_table(params, cfg), cfg.logit_softcap)
    return logits[:, 0, :], cache


def lm_decode_step(params, cfg: ModelConfig, token: torch.Tensor, cur_len, cache: dict,
                   kernel: bool = True):
    """token: (B,) int; cur_len: int (tokens already cached).  Returns (logits,
    the cache updated in place)."""
    x = embed_tokens(token[:, None], params["embed"], cfg.compute_dtype)
    cur_len = int(cur_len)
    for i, (p, flag) in enumerate(zip(params["blocks"], layer_flags(cfg))):
        x, _ = layer_decode(p, cfg, x, cur_len, _layer_cache(cache, i), flag, kernel=kernel)
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = unembed(h[:, -1:, :], _unembed_table(params, cfg), cfg.logit_softcap)
    return logits[:, 0, :], cache
