"""GQA attention of the dense family: training, prefill and cached decode.

The port of the dense subset of ``repro.models.attention``.  The reference
computes attention with einsums and names the Pallas kernels as having the
same semantics; here the card runs those kernels:

* prefill (and the full-sequence ``attention_train``) calls K3,
  :func:`repro_torch.kernels.flash_attention`, causal, with K and V left
  unexpanded (K3 reads each query-head group's KV head itself);
* decode writes the new K/V at slot ``cur_len`` and calls K4,
  :func:`repro_torch.kernels.decode_attention`, over the layer's cache with
  ``lengths = cur_len + 1`` for every row.

On the CPU, and on the card only under ``kernel=False`` (the oracle of the
kernel route), the reference's path runs: K/V expanded to every head,
``_causal_mask`` or the cache's positions as the mask, scores in float32
masked to ``finfo(float32).min``, probabilities cast to the compute dtype
before the PV product.  There is no fallback between the two: a head dim
the kernels have no instance for raises their ``ValueError``.

The KV cache is updated in place.  The reference's sharding constraints
(``constrain_attention*`` of ``distributed/ctx.py``) are no-ops outside a
mesh, and the port has no mesh, so it drops them.  Sliding windows, ring
caches, the banded ``_local_attention`` and ``cross_attention`` belong to
the families not ported yet (ROADMAP.md, Queue 1 item 11).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import apply_rope, init_dense


class KVCache(NamedTuple):
    """A dense layer's KV cache: ``pos`` holds the absolute position stored
    in each slot (-1 = empty)."""

    k: torch.Tensor       # (B, S_cache, KVH, hd)
    v: torch.Tensor       # (B, S_cache, KVH, hd)
    pos: torch.Tensor     # (S_cache,) int32, absolute positions, -1 = empty


def init_attention(generator, cfg: ModelConfig, device) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd = cfg.param_dtype
    return {
        "wq": init_dense(generator, (d, h, hd), pd, device, fan_in=d),
        "wk": init_dense(generator, (d, kvh, hd), pd, device, fan_in=d),
        "wv": init_dense(generator, (d, kvh, hd), pd, device, fan_in=d),
        "wo": init_dense(generator, (h, hd, d), pd, device, fan_in=h * hd),
    }


def _sdpa(q, k, v, mask, compute_dtype):
    """SDPA over flat heads.  q: (B, Sq, H, hd); k/v: (B, Skv, H, hd) (KV
    pre-expanded to H heads); mask broadcastable to (B, H, Sq, Skv)."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * (hd ** -0.5)
    scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(compute_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _expand_kv(x, n_heads: int):
    """(B, S, KVH, hd) -> (B, S, H, hd) by repeating each KV head."""
    kvh = x.shape[2]
    if kvh == n_heads:
        return x
    return torch.repeat_interleave(x, n_heads // kvh, dim=2)


def _causal_mask(q_len: int, kv_len: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """Boolean (q_len, kv_len): True = attend (full causal)."""
    q_pos = q_offset + torch.arange(q_len, dtype=torch.int32, device=device)[:, None]
    k_pos = torch.arange(kv_len, dtype=torch.int32, device=device)[None, :]
    return k_pos <= q_pos


def _project(x, w, cd):
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, hd = w.shape
    return torch.matmul(x, w.to(cd).reshape(d, h * hd)).unflatten(-1, (h, hd))


def _out(o, w, cd):
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    h, hd, d = w.shape
    return torch.matmul(o.flatten(-2), w.to(cd).reshape(h * hd, d))


def _qkv(x, p, cd):
    return _project(x, p["wq"], cd), _project(x, p["wk"], cd), _project(x, p["wv"], cd)


def _kernel_route(x: torch.Tensor, kernel: bool) -> bool:
    return kernel and x.device.type == "cuda"


def _causal_attention(q, k, v, cfg: ModelConfig, kernel: bool):
    """Causal self-attention of q (B, S, H, hd) over k, v (B, S, KVH, hd):
    K3 on the card, the reference's masked einsums elsewhere."""
    s = q.shape[1]
    if _kernel_route(q, kernel):
        # blocks of S: the reference's block sizes only constrain S, and K3
        # picks its own tiles
        return ops.flash_attention(q, k, v, causal=True, block_q=s, block_k=s)
    mask = _causal_mask(s, s, device=q.device)[None, None]
    return _sdpa(q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads), mask,
                 cfg.compute_dtype)


def attention_train(x, p, cfg: ModelConfig, positions, kernel: bool = True):
    """Causal self-attention over a full sequence (no cache)."""
    cd = cfg.compute_dtype
    q, k, v = _qkv(x, p, cd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return _out(_causal_attention(q, k, v, cfg, kernel), p["wo"], cd)


# ---------------------------------------------------------------------------
# Cached decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.kv_cache_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.kv_cache_dtype, device=device),
        pos=torch.full((max_len,), -1, dtype=torch.int32, device=device),
    )


def prefill_attention(x, p, cfg: ModelConfig, positions, cache: KVCache,
                      kernel: bool = True):
    """Full-sequence attention that also fills the KV cache, in place: the
    S new K/V rows at slots 0..S-1, zeros and position -1 past them, as the
    reference's padded cache holds.  The cache must have at least S slots
    (a shorter one is the ring buffer of the windowed families)."""
    cd = cfg.compute_dtype
    s = x.shape[1]
    cache_len = cache.k.shape[1]
    if cache_len < s:
        raise ValueError(f"a cache of {cache_len} slots cannot hold a prompt of {s} tokens; "
                         "ring caches belong to the windowed families, not ported yet")
    q, k, v = _qkv(x, p, cd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache.k[:, :s] = k.to(cache.k.dtype)
    cache.k[:, s:] = 0
    cache.v[:, :s] = v.to(cache.v.dtype)
    cache.v[:, s:] = 0
    slots = torch.arange(cache_len, dtype=torch.int32, device=x.device)
    cache.pos.copy_(torch.where(slots < s, slots, -1))
    return _out(_causal_attention(q, k, v, cfg, kernel), p["wo"], cd), cache


def decode_attention(x, p, cfg: ModelConfig, cache: KVCache, cur_len: int,
                     kernel: bool = True):
    """One-token attention against the cache.  x: (B, 1, D); ``cur_len``:
    the absolute position of the new token, written at slot ``cur_len`` in
    place.  Slots 0..cur_len-1 must hold positions 0..cur_len-1 (a prefill
    and the decode steps after it), so that the reference's mask ``0 <= pos
    <= cur_len`` is the first ``cur_len + 1`` slots, K4's ``lengths``."""
    cd = cfg.compute_dtype
    b = x.shape[0]
    cur_len = int(cur_len)
    cache_len = cache.k.shape[1]
    if not 0 <= cur_len < cache_len:
        raise ValueError(f"position {cur_len} is past the cache's {cache_len} slots; "
                         "ring caches belong to the windowed families, not ported yet")
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(x, p, cd)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    cache.k[:, cur_len] = k[:, 0].to(cache.k.dtype)
    cache.v[:, cur_len] = v[:, 0].to(cache.v.dtype)
    cache.pos[cur_len] = cur_len
    kc, vc = cache.k.to(cd), cache.v.to(cd)
    if _kernel_route(x, kernel):
        lengths = torch.full((b,), cur_len + 1, dtype=torch.int32, device=x.device)
        out = ops.decode_attention(q[:, 0], kc, vc, lengths, block_k=cache_len)[:, None]
    else:
        mask = (cache.pos >= 0) & (cache.pos <= cur_len)
        out = _sdpa(q, _expand_kv(kc, cfg.n_heads), _expand_kv(vc, cfg.n_heads),
                    mask[None, None, None, :], cd)
    return _out(out, p["wo"], cd), cache
