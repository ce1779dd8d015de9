"""Encoder-decoder backbone (seamless-m4t): a bidirectional encoder over the
modality stub's frame embeddings, and a causal decoder with
cross-attention to the encoder's output.

The port of ``repro.models.encdec``.  The speech frontend is a stub:
``batch["frontend"]`` holds (B, frames, D) embeddings, and a trainable
projection, ``frontend_proj``, maps them into the encoder.  The reference
stacks the layers of each stack on a leading axis; here ``params["encoder"]``
and ``params["decoder"]`` are lists of per-layer dicts, and each decoder
layer holds its cross-attention's weights under ``xattn``.  There is one
token table, ``embed``: the decoder's embedding and its unembedding,
whatever ``cfg.tie_embeddings`` says (the reference has no other).

``kernel`` selects the attention route as in :mod:`.attention`: on the card
the encoder's layers run K3 without a mask, the decoder's self-attention
K3 causally and its cross-attention K3 without a mask over the memory's
rows; a decode step runs K4 over the self cache and K4 over the cross
cache (``lengths`` = the memory's rows).  ``kernel=False`` is the
reference's einsum path, the one to differentiate.

The decode cache is the reference's, ``{"kv": KVCache, "xk", "xv"}``, each
leaf stacked on a leading decoder-layer axis: the self-attention's cache of
``s_max`` slots, updated in place, and the cross-attention's K and V of the
encoder memory in ``kv_cache_dtype``, (L, B, src_len, KVH, hd).  The
prefill sets ``xk`` and ``xv`` to the memory's, at the memory's length, as
the reference's prefill returns them whatever ``src_len`` the cache was
made with.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..distributed.ctx import constrain_tokens_3d, gather_sequence, last_position
from .attention import (
    KVCache,
    _decode_kernel,
    _expand_kv,
    _kernel_route,
    _out,
    _project,
    _sdpa,
    attention_train,
    cross_attention,
    decode_attention,
    init_attention,
    init_kv_cache,
    prefill_attention,
)
from .layers import (
    embed_tokens,
    init_dense,
    init_embedding,
    init_mlp,
    init_rms_norm,
    mlp,
    rms_norm,
    unembed,
)
from .transformer import _chunk_ce, _positions, _remat


def init_enc_layer(generator, cfg: ModelConfig, device) -> dict:
    d, pd = cfg.d_model, cfg.param_dtype
    return {
        "ln1": init_rms_norm(d, pd, device),
        "attn": init_attention(generator, cfg, device),
        "ln2": init_rms_norm(d, pd, device),
        "mlp": init_mlp(generator, d, cfg.d_ff, pd, device),
    }


def init_dec_layer(generator, cfg: ModelConfig, device) -> dict:
    d, pd = cfg.d_model, cfg.param_dtype
    return {
        "ln1": init_rms_norm(d, pd, device),
        "attn": init_attention(generator, cfg, device),
        "lnx": init_rms_norm(d, pd, device),
        "xattn": init_attention(generator, cfg, device),
        "ln2": init_rms_norm(d, pd, device),
        "mlp": init_mlp(generator, d, cfg.d_ff, pd, device),
    }


def init_encdec_params(generator, cfg: ModelConfig, device) -> dict:
    d, pd = cfg.d_model, cfg.param_dtype
    return {
        "frontend_proj": init_dense(generator, (d, d), pd, device),
        "embed": init_embedding(generator, cfg.vocab_size, d, pd, device),
        "encoder": [init_enc_layer(generator, cfg, device) for _ in range(cfg.n_enc_layers)],
        "decoder": [init_dec_layer(generator, cfg, device) for _ in range(cfg.n_dec_layers)],
        "enc_ln": init_rms_norm(d, pd, device),
        "final_ln": init_rms_norm(d, pd, device),
    }


def param_count(cfg: ModelConfig) -> int:
    """Parameters of :func:`init_encdec_params`, from the shapes alone."""
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = d * (h + 2 * kvh) * hd + h * hd * d
    ffn = 3 * d * cfg.d_ff
    enc = 2 * d + attn + ffn
    dec = 3 * d + 2 * attn + ffn
    return (d * d + cfg.vocab_size * d + cfg.n_enc_layers * enc + cfg.n_dec_layers * dec
            + 2 * d)


def encode(params, cfg: ModelConfig, frames: torch.Tensor, kernel: bool = True):
    """frames: (B, S_src, D) stub embeddings -> the encoder memory."""
    cd = cfg.compute_dtype
    x = torch.matmul(frames.to(cd), params["frontend_proj"].to(cd))
    positions = _positions(x.shape[0], x.shape[1], x.device)

    def body(h, p):
        h = constrain_tokens_3d(h)
        hn = rms_norm(h, p["ln1"], cfg.norm_eps)
        h = h + attention_train(hn, p["attn"], cfg, positions, bidirectional=True,
                                kernel=kernel)
        hn = rms_norm(h, p["ln2"], cfg.norm_eps)
        return h + mlp(hn, p["mlp"], cfg.act, cd)

    for p in params["encoder"]:
        x = _remat(lambda h, p=p: body(h, p), cfg)(x)
    return rms_norm(x, params["enc_ln"], cfg.norm_eps)


def decode_train(params, cfg: ModelConfig, tokens: torch.Tensor, memory: torch.Tensor,
                 kernel: bool = True):
    """Teacher-forced decoder hidden states (final-normed)."""
    cd = cfg.compute_dtype
    x = embed_tokens(tokens, params["embed"], cd)
    positions = _positions(x.shape[0], x.shape[1], x.device)

    def body(h, p):
        h = constrain_tokens_3d(h)
        hn = rms_norm(h, p["ln1"], cfg.norm_eps)
        h = h + attention_train(hn, p["attn"], cfg, positions, kernel=kernel)
        hn = rms_norm(h, p["lnx"], cfg.norm_eps)
        h = h + cross_attention(hn, memory, p["xattn"], cfg, kernel=kernel)
        hn = rms_norm(h, p["ln2"], cfg.norm_eps)
        return h + mlp(hn, p["mlp"], cfg.act, cd)

    for p in params["decoder"]:
        x = _remat(lambda h, p=p: body(h, p), cfg)(x)
    return rms_norm(x, params["final_ln"], cfg.norm_eps)


def encdec_loss(params, cfg: ModelConfig, batch: dict, kernel: bool = True):
    """Next-token CE of the decoder over the target tokens; returns
    ``(loss, {"ce", "aux"})`` with a zero aux, as the reference."""
    memory = encode(params, cfg, batch["frontend"], kernel=kernel)
    tokens = batch["tokens"]
    h = decode_train(params, cfg, tokens, memory, kernel=kernel)
    B, S = tokens.shape
    n_pred = S - 1
    loss = _chunk_ce(gather_sequence(h)[:, :n_pred], tokens[:, 1:], params["embed"],
                     0.0) / (B * n_pred)
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=h.device)}


def encdec_logits(params, cfg: ModelConfig, batch: dict, kernel: bool = True):
    """Full (B, S, V) float32 logits of the decoder (small configs / tests)."""
    memory = encode(params, cfg, batch["frontend"], kernel=kernel)
    return unembed(decode_train(params, cfg, batch["tokens"], memory, kernel=kernel),
                   params["embed"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_encdec_cache(cfg: ModelConfig, batch: int, s_max: int, src_len: int, device) -> dict:
    L = cfg.n_dec_layers
    kv = init_kv_cache(cfg, batch, s_max, device)
    xshape = (L, batch, src_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "kv": KVCache(*(torch.stack([x] * L) for x in kv)),
        "xk": torch.zeros(xshape, dtype=cfg.kv_cache_dtype, device=device),
        "xv": torch.zeros(xshape, dtype=cfg.kv_cache_dtype, device=device),
    }


def _self_cache(cache: dict, i: int) -> KVCache:
    """Decoder layer ``i``'s self-attention cache, as views."""
    return KVCache(*(x[i] for x in cache["kv"]))


def encdec_prefill(params, cfg: ModelConfig, batch: dict, cache: dict, kernel: bool = True):
    """Encode the source, prefill the decoder's self cache in place and
    compute the cross K/V; returns (last-position logits, cache)."""
    cd = cfg.compute_dtype
    memory = encode(params, cfg, batch["frontend"], kernel=kernel)
    x = embed_tokens(batch["tokens"], params["embed"], cd)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    xks, xvs = [], []
    for i, p in enumerate(params["decoder"]):
        x = constrain_tokens_3d(x)
        hn = rms_norm(x, p["ln1"], cfg.norm_eps)
        att, _ = prefill_attention(hn, p["attn"], cfg, positions, _self_cache(cache, i),
                                   kernel=kernel)
        x = x + att
        hn = rms_norm(x, p["lnx"], cfg.norm_eps)
        x = x + cross_attention(hn, memory, p["xattn"], cfg, kernel=kernel)
        xks.append(_project(memory, p["xattn"]["wk"], cd).to(cfg.kv_cache_dtype))
        xvs.append(_project(memory, p["xattn"]["wv"], cd).to(cfg.kv_cache_dtype))
        hn = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp(hn, p["mlp"], cfg.act, cd)
    cache["xk"], cache["xv"] = torch.stack(xks), torch.stack(xvs)
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return unembed(last_position(h), params["embed"])[:, 0, :], cache


def encdec_decode_step(params, cfg: ModelConfig, token: torch.Tensor, cur_len, cache: dict,
                       kernel: bool = True):
    """token: (B,) int; cur_len: int (tokens already cached).  Returns
    (logits, the cache updated in place)."""
    cd = cfg.compute_dtype
    x = embed_tokens(token[:, None], params["embed"], cd)
    cur_len = int(cur_len)
    for i, p in enumerate(params["decoder"]):
        x = constrain_tokens_3d(x)
        hn = rms_norm(x, p["ln1"], cfg.norm_eps)
        att, _ = decode_attention(hn, p["attn"], cfg, _self_cache(cache, i), cur_len,
                                  kernel=kernel)
        x = x + att
        hn = rms_norm(x, p["lnx"], cfg.norm_eps)
        x = x + _cached_cross(hn, cache["xk"][i], cache["xv"][i], p["xattn"], cfg,
                              kernel=kernel)
        hn = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp(hn, p["mlp"], cfg.act, cd)
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return unembed(h[:, -1:, :], params["embed"])[:, 0, :], cache


def _cached_cross(x, xk, xv, p, cfg: ModelConfig, kernel: bool = True):
    """x (B, 1, D) over the cross cache's K and V (B, S_src, KVH, hd), cast
    back to the compute dtype: K4 over all S_src rows on the card, the
    reference's einsums over an all-true mask elsewhere."""
    cd = cfg.compute_dtype
    q = _project(x, p["wq"], cd)
    xk, xv = xk.to(cd), xv.to(cd)
    if _kernel_route(x, kernel):
        out = _decode_kernel(q[:, 0], xk, xv, xk.shape[1], None)[:, None]
    else:
        mask = torch.ones((1, 1, x.shape[1], xk.shape[1]), dtype=torch.bool, device=x.device)
        out = _sdpa(q, _expand_kv(xk, cfg.n_heads), _expand_kv(xv, cfg.n_heads), mask, cd)
    return _out(out, p["wo"], cd)
