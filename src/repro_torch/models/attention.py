"""GQA attention: training (full or sliding-window causal, or
bidirectional), cross-attention, prefill and cached decode, with the ring
cache of the windowed layers.

The port of ``repro.models.attention``.  The reference computes attention
with einsums and names the Pallas kernels as having the same semantics;
here the card runs those kernels:

* prefill (and the full-sequence ``attention_train``) calls K3,
  :func:`repro_torch.kernels.flash_attention`, causal, with the layer's
  window (hymba: 2048; 0 elsewhere) and K and V left unexpanded (K3 reads
  each query-head group's KV head itself); the encoder's bidirectional
  layers and ``cross_attention`` call it with ``causal=False``, the latter
  with as many keys as the memory has rows;
* decode writes the new K/V at slot ``cur_len % cache_len`` and calls K4,
  :func:`repro_torch.kernels.decode_attention`, over the layer's cache.

On the CPU, and on the card only under ``kernel=False`` (the oracle of the
kernel route), the reference's path runs: K/V expanded to every head,
``_causal_mask`` (or the banded :func:`_local_attention` where
``cfg.local_attention`` asks for it), an all-true mask (bidirectional and
cross-attention) or the cache's positions as the mask, scores in float32
masked to ``finfo(float32).min``, probabilities cast to the compute dtype
before the PV product.  There is no fallback between the
two: a head dim the kernels have no instance for raises their
``ValueError``.

**The ring cache.**  A windowed layer's cache has ``min(window, s_max)``
slots.  A prefill longer than the cache stores its last ``cache_len``
tokens at slots 0..cache_len-1; a decode step writes at slot ``cur_len %
cache_len``; ``pos`` holds each slot's absolute position, and the mask is
``0 <= pos <= cur_len`` and ``pos > cur_len - window``, as the reference
keeps them.  K4 reads the first ``lengths`` slots of a cache, and softmax
does not depend on slot order, so on the kernel route a windowed layer's
decode copies the step's validity mask to the host (one 1-byte-per-slot
read per layer and step) and

* passes the cache as it is, with ``lengths`` = the count of valid slots,
  when the valid slots are the first ones: a prompt that fits the cache,
  or one whose length is a multiple of it, keeps ``slot == pos %
  cache_len`` and so a prefix;
* otherwise gathers the valid slots to the front of a scratch copy (a
  stable sort of the mask, then ``index_select``) and passes that, with
  the same ``lengths``.  This is the case of a prompt longer than the
  window and not a multiple of it (ROADMAP.md § 3.9): the reference's
  prefill then stores position p at a slot other than ``p % cache_len``,
  the first decode steps overwrite positions still inside the window, and
  the reference attends to what is left; the port matches it on both
  routes.

A layer without a window behaves the same way once its sequence outgrows
its cache, as the reference's does: a prefill longer than the cache keeps
its last ``cache_len`` tokens at slots 0..cache_len-1, and a step past the
cache overwrites slot ``cur_len % cache_len`` (ROADMAP.md § 3.10: the vlm
engine's image tokens take it there).  Its mask is ``0 <= pos <=
cur_len``, and K4 reads the first ``min(cur_len + 1, cache_len)`` slots
(:func:`decode_attention` proves that this is the mask) without reading
anything to the host.

The KV cache is updated in place (``store_rows``/``fill_rows`` of
:mod:`repro_torch.distributed.ctx`, which on a ``DTensor`` cache write each
rank's own block, whatever dim ``cache_specs`` shards).

**On a mesh.**  Under a step builder's sharding context the tensors are
``DTensor`` s, and the reference's constraint sites pin their layouts:
``constrain_attention`` on the plain route's q and expanded K/V (heads over
``"model"``, or the queries' sequence where the heads do not divide it) and
``constrain_attention_decode`` on a decode step's, and the plain route
computes on each rank's blocks in those layouts (a sequence-sharded
query block under the causal mask at its offset; a sequence-sharded cache
through its softmax's statistics, reduced across the ranks).  On plain
tensors the constraints are no-ops, so every single-device path is as it
was.  On the kernel route
a ``DTensor`` reaches K3 and K4 as each rank's local tensors
(``to_local``), and the output is wrapped back (``from_local``):

* K3: K/V stay unexpanded (the GQA group local) where both head counts
  divide the ``"model"`` axis, else they are expanded first, as the
  reference's constraint does; then ``constrain_attention`` pins the layout
  and K3 runs on the rank's batch rows and heads.  Where it picks the
  sequence layout (heads indivisible by the axis: hymba's 25, llama4's 40,
  paligemma's 8 heads on 16), K3, which takes no query offset, gets the
  queries of every position: q is redistributed to replicated over the
  sequence before K3 and the output is constrained back to the sequence
  layout after.
* K4: ``constrain_attention_decode``'s layout splits the cache's slots
  across ranks, and K4, which returns no softmax statistics, cannot merge
  partial results; so the cache is redistributed to the batch rows and, where
  both head counts divide the ``"model"`` axis, the heads, with every slot
  whole (an all-to-all of the layer's cache per step), and K4 runs on the
  rank's heads.

A kernel that fails under a mesh raises; there is no quiet plain route.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ModelConfig
from ..distributed.ctx import (
    constrain,
    constrain_attention,
    constrain_attention_decode,
    fill_rows,
    from_block,
    is_dtensor,
    local_block,
    local_offset,
    mesh_matmul,
    model_axis_size,
    model_split,
    store_rows,
)
from ..kernels import ops
from .layers import apply_rope, init_dense


class KVCache(NamedTuple):
    """A layer's KV cache; for sliding-window layers a ring of the window's
    slots.  ``pos`` holds the absolute position stored in each slot (-1 =
    empty), so masking never reasons about the ring's wrap."""

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
    """(B, S, KVH, hd) -> (B, S, H, hd) by repeating each KV head.  A
    ``DTensor`` is expanded on each rank's block with its KV heads whole;
    where ``"model"`` leaves it whole and splits the H heads, each rank keeps
    the heads it will attend with (the layout ``constrain_attention`` pins),
    so that no gather is needed, nor one of the gradient in the backward
    pass."""
    kvh = x.shape[2]
    if kvh == n_heads:
        return x
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        mesh = x.device_mesh
        whole = [Replicate() if p.is_shard(2) else p for p in x.placements]
        out = list(whole)
        if model_split(n_heads):
            i = mesh.mesh_dim_names.index("model")
            if whole[i].is_replicate():
                out[i] = Shard(2)
        local = torch.repeat_interleave(local_block(x, whole, out), n_heads // kvh, dim=2)
        for i, p in enumerate(out):
            if p.is_shard(2):
                local = local.chunk(mesh.size(i), dim=2)[mesh.get_coordinate()[i]]
        return from_block(local, mesh, out, (*x.shape[:2], n_heads, x.shape[3]))
    return torch.repeat_interleave(x, n_heads // kvh, dim=2)


def _causal_mask(q_len: int, kv_len: int, window: int = 0, q_offset: int = 0,
                 device=None) -> torch.Tensor:
    """Boolean (q_len, kv_len): True = attend.  window=0 -> full causal."""
    q_pos = q_offset + torch.arange(q_len, dtype=torch.int32, device=device)[:, None]
    k_pos = torch.arange(kv_len, dtype=torch.int32, device=device)[None, :]
    mask = k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def _project(x, w, cd):
    """``einsum("bsd,dhk->bshk")`` as one matrix product; on ``DTensor`` s,
    with whole heads over ``"model"`` where they divide it
    (:func:`~repro_torch.distributed.ctx.mesh_matmul`)."""
    d, h, hd = w.shape
    w = w.to(cd).reshape(d, h * hd)
    if is_dtensor(x):
        return mesh_matmul(x, w, "cols" if model_split(h) else None).unflatten(-1, (h, hd))
    return torch.matmul(x, w).unflatten(-1, (h, hd))


def _out(o, w, cd):
    """``einsum("bshk,hkd->bsd")`` as one matrix product; on ``DTensor`` s,
    over each rank's heads, the partial sums reduced over ``"model"``."""
    h, hd, d = w.shape
    w = w.to(cd).reshape(h * hd, d)
    if is_dtensor(o):
        return mesh_matmul(o.flatten(-2), w, "rows" if model_split(h) else None)
    return torch.matmul(o.flatten(-2), w)


def _qkv(x, p, cd):
    return _project(x, p["wq"], cd), _project(x, p["wk"], cd), _project(x, p["wv"], cd)


def _kernel_route(x: torch.Tensor, kernel: bool) -> bool:
    return kernel and x.device.type == "cuda"


def _local_attention(q, k, v, window: int, cd):
    """Banded sliding-window attention in chunks of W: chunk i attends to
    chunks {i-1, i}, O(S * 2W) instead of O(S^2), the same function as the
    masked full-score path.  q/k/v: (B, S, H, hd) with KV pre-expanded;
    S % W == 0."""
    B, S, H, hd = q.shape
    W = window
    nc = S // W
    qc = q.reshape(B, nc, W, H, hd)
    kc = k.reshape(B, nc, W, H, hd)
    vc = v.reshape(B, nc, W, H, hd)
    k_prev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    k2 = torch.cat([k_prev, kc], dim=2)                  # (B, nc, 2W, H, hd)
    v2 = torch.cat([v_prev, vc], dim=2)
    scores = torch.einsum("bcqhd,bckhd->bchqk", qc, k2).float()
    scores = scores * (hd ** -0.5)
    qi = torch.arange(W, device=q.device)[:, None]       # local q index
    ki = torch.arange(2 * W, device=q.device)[None, :]   # index into [prev|cur]
    rel = qi + W - ki                                    # k_pos = q_pos - rel
    band = (rel >= 0) & (rel < W)
    ci = torch.arange(nc, device=q.device)[:, None, None]
    valid_prev = (ci > 0) | (ki[None] >= W)              # chunk 0 has no prev
    mask = band[None] & valid_prev                       # (nc, W, 2W)
    scores = torch.where(mask[None, :, None], scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(cd)
    out = torch.einsum("bchqk,bckhd->bcqhd", probs, v2)
    return out.reshape(B, S, H, hd)


def _banded(cfg: ModelConfig, s: int, window: int) -> bool:
    """Whether the reference takes its banded path (``cfg.local_attention``)."""
    return cfg.local_attention and window > 0 and s % window == 0 and s >= 2 * window


def _heads_placements(placements, mesh, heads: int, counts):
    """Placements for a kernel on each rank's batch rows and heads: a mesh
    dim that shards the batch (dim 0) in ``placements`` keeps it, the
    ``"model"`` axis shards dim ``heads`` where it divides every head count
    in ``counts`` (and the context splits heads at all), and every other
    dim is whole."""
    from torch.distributed.tensor import Replicate, Shard

    tp = model_axis_size()
    by_heads = tp > 1 and all(n % tp == 0 for n in counts)
    return tuple(p if p.is_shard(0) else Shard(heads) if by_heads and name == "model"
                 else Replicate() for p, name in zip(placements, mesh.mesh_dim_names))


def _flash(q, k, v, cfg: ModelConfig, **kw):
    """K3 on q (B, S, H, hd) and unexpanded k, v; on ``DTensor`` s, on each
    rank's local heads, as the module's docstring sets out."""
    if not is_dtensor(q):
        return ops.flash_attention(q, k, v, **kw)
    tp = model_axis_size()
    if q.shape[2] % tp or k.shape[2] % tp:
        k, v = _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads)
    q, k, v = constrain_attention(q, k, v)
    by_sequence = any(p.is_shard(1) for p in q.placements)
    mesh = q.device_mesh
    placements = _heads_placements(q.placements, mesh, 2, (q.shape[2], k.shape[2]))
    lq, lk, lv = (t.redistribute(mesh, placements).to_local() for t in (q, k, v))
    out = from_block(ops.flash_attention(lq, lk, lv, **kw), mesh, placements, q.shape)
    return constrain(out, "dp", "model", None, None) if by_sequence else out


def _mesh_sdpa(q, ke, ve, cfg: ModelConfig, causal: bool, window: int):
    """The plain route's attention of ``DTensor`` q (B, S, H, hd) over the
    expanded ke, ve (B, S_kv, H, hd) as ``constrain_attention`` pinned
    them: each rank computes its batch rows and heads, and in the sequence
    layout its query rows at their offset over every key, with the
    reference's masked einsums (or its banded form over whole sequences);
    no collective but the redistributes to that layout."""
    from torch.distributed.tensor import Replicate

    mesh = q.device_mesh
    qp = tuple(p if any(p.is_shard(d) for d in (0, 1, 2)) else Replicate() for p in q.placements)
    kp = tuple(Replicate() if p.is_shard(1) else p for p in qp)
    q = q.redistribute(mesh, qp)
    lq = q.to_local()
    # in the sequence layout every rank attends with its own queries over
    # every key: its gradient of the keys and values is a partial sum
    lk, lv = local_block(ke, kp, qp), local_block(ve, kp, qp)
    s, s_kv, cd = lq.shape[1], lk.shape[1], cfg.compute_dtype
    if not causal:
        out = _sdpa(lq, lk, lv, torch.ones((1, 1, s, s_kv), dtype=torch.bool, device=lq.device),
                    cd)
    elif s == q.shape[1] and _banded(cfg, s, window):
        out = _local_attention(lq, lk, lv, window, cd)
    else:
        mask = _causal_mask(s, s_kv, window, q_offset=local_offset(q, 1), device=lq.device)
        out = _sdpa(lq, lk, lv, mask[None, None], cd)
    return from_block(out, q.device_mesh, qp, q.shape)


def _mesh_decode_sdpa(q, ke, ve, mask, cd):
    """The plain route's decode attention of ``DTensor`` q (B, 1, H, hd)
    over the expanded cache ke, ve (B, S_cache, H, hd) as
    ``constrain_attention_decode`` pinned them: where the cache's slots are
    split across ranks, each rank takes the masked softmax's statistics and
    the PV product over its own slots, and the (B, H, 1) maxima and sums
    and the (B, 1, H, hd) partial outputs are reduced across the ranks that
    split the slots; the function is the reference's."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate

    mesh = ke.device_mesh
    kp = tuple(p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in ke.placements)
    qp = tuple(p if p.is_shard(0) else Replicate() for p in kp)
    ke = ke.redistribute(mesh, kp)
    lq, lk, lv = (q.redistribute(mesh, qp).to_local(), ke.to_local(),
                  ve.redistribute(mesh, kp).to_local())
    first = local_offset(ke, 1)
    lmask = mask.full_tensor()[first:first + lk.shape[1]]
    split = [i for i, p in enumerate(kp) if p.is_shard(1)]

    def reduce(t, op):
        for i in split:
            t = funcol.all_reduce(t, op, (mesh, i))
        return t

    hd = lq.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", lq, lk).float() * (hd ** -0.5)
    scores = torch.where(lmask[None, None, None, :], scores, torch.finfo(torch.float32).min)
    m = reduce(scores.amax(dim=-1, keepdim=True), "max")
    e = torch.exp(scores - m)
    probs = (e / reduce(e.sum(dim=-1, keepdim=True), "sum")).to(cd)
    out = reduce(torch.einsum("bhqk,bkhd->bqhd", probs, lv), "sum")
    return from_block(out, q.device_mesh, qp, q.shape)


def _causal_attention(q, k, v, cfg: ModelConfig, window: int, kernel: bool):
    """Causal self-attention of q (B, S, H, hd) over k, v (B, S, KVH, hd)
    within ``window`` (0 = none): K3 on the card, the reference's masked
    einsums (or its banded form) elsewhere."""
    s = q.shape[1]
    if _kernel_route(q, kernel):
        # blocks of S: the reference's block sizes only constrain S, and K3
        # picks its own tiles
        return _flash(q, k, v, cfg, causal=True, window=window, block_q=s, block_k=s)
    q, ke, ve = constrain_attention(q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads))
    if is_dtensor(q):
        return _mesh_sdpa(q, ke, ve, cfg, True, window)
    if _banded(cfg, s, window):
        return _local_attention(q, ke, ve, window, cfg.compute_dtype)
    mask = _causal_mask(s, s, window, device=q.device)[None, None]
    return _sdpa(q, ke, ve, mask, cfg.compute_dtype)


def _full_attention(q, k, v, cfg: ModelConfig, kernel: bool):
    """Every query of q (B, S, H, hd) over every row of k, v (B, S_kv, KVH,
    hd), S_kv of its own: K3 without a mask on the card, the reference's
    einsums over an all-true mask elsewhere."""
    s, s_kv = q.shape[1], k.shape[1]
    if _kernel_route(q, kernel):
        return _flash(q, k, v, cfg, causal=False, block_q=s, block_k=s_kv)
    mask = torch.ones((1, 1, s, s_kv), dtype=torch.bool, device=q.device)
    q, ke, ve = constrain_attention(q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads))
    if is_dtensor(q):
        return _mesh_sdpa(q, ke, ve, cfg, False, 0)
    return _sdpa(q, ke, ve, mask, cfg.compute_dtype)


def attention_train(x, p, cfg: ModelConfig, positions, window: int = 0,
                    bidirectional: bool = False, kernel: bool = True):
    """Self-attention over a full sequence (no cache): causal within
    ``window`` (0 = none), or ``bidirectional`` (the encoder's: every
    position over every position, never banded)."""
    cd = cfg.compute_dtype
    q, k, v = _qkv(x, p, cd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    att = (_full_attention(q, k, v, cfg, kernel) if bidirectional
           else _causal_attention(q, k, v, cfg, window, kernel))
    return _out(att, p["wo"], cd)


def cross_attention(x, memory, p, cfg: ModelConfig, kernel: bool = True):
    """x (B, S, D) attending over ``memory`` (B, S_src, D): q from x, k and
    v from the memory, no rope and no mask."""
    cd = cfg.compute_dtype
    q = _project(x, p["wq"], cd)
    k, v = _project(memory, p["wk"], cd), _project(memory, p["wv"], cd)
    return _out(_full_attention(q, k, v, cfg, kernel), p["wo"], cd)


# ---------------------------------------------------------------------------
# Cached decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> KVCache:
    """``max_len`` slots; a sliding-window layer passes min(W, seq)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.kv_cache_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.kv_cache_dtype, device=device),
        pos=torch.full((max_len,), -1, dtype=torch.int32, device=device),
    )


def prefill_attention(x, p, cfg: ModelConfig, positions, cache: KVCache, window: int = 0,
                      kernel: bool = True):
    """Full-sequence attention that also fills the KV cache, in place.  A
    cache of at least S slots gets the S new K/V rows at slots 0..S-1, zeros
    and position -1 past them, as the reference's padded cache holds; a
    shorter one (a windowed layer's ring, or a full layer's cache that the
    sequence outgrows, § 3.10) gets the last ``cache_len`` tokens at slots
    0..cache_len-1 with their positions."""
    cd = cfg.compute_dtype
    s = x.shape[1]
    cache_len = cache.k.shape[1]
    q, k, v = _qkv(x, p, cd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache_len < s:
        store_rows(cache.k, 1, 0, k[:, s - cache_len:])
        store_rows(cache.v, 1, 0, v[:, s - cache_len:])
        store_rows(cache.pos, 0, 0,
                   torch.arange(s - cache_len, s, dtype=torch.int32, device=x.device))
    else:
        store_rows(cache.k, 1, 0, k)
        fill_rows(cache.k, 1, s, cache_len, 0)
        store_rows(cache.v, 1, 0, v)
        fill_rows(cache.v, 1, s, cache_len, 0)
        slots = torch.arange(cache_len, dtype=torch.int32, device=x.device)
        store_rows(cache.pos, 0, 0, torch.where(slots < s, slots, -1))
    return _out(_causal_attention(q, k, v, cfg, window, kernel), p["wo"], cd), cache


def _decode_mask(pos, cur_len: int, window: int):
    """The slots a decode step at ``cur_len`` attends to, from their
    positions: (S_cache,) bool."""
    mask = (pos >= 0) & (pos <= cur_len)
    if window > 0:
        mask &= pos > cur_len - window
    return mask


def _ring_slots(kc, vc, mask):
    """K4's inputs for a windowed layer's cache: (k, v, the count of valid
    slots).  The cache itself where its valid slots are its first ones,
    else a copy with the valid slots gathered to the front in slot order
    (a stable sort of the mask); see the module's docstring."""
    # The mask is read on the host, once per windowed layer and decode step:
    # a host sync on the launch path (ROADMAP.md § 3.9), left standing until
    # the count and the gather move to the card.
    # repro-torch-lint: disable=RPT002 (the § 3.9 host read, left standing)
    valid = mask.cpu()
    # repro-torch-lint: disable=RPT002 (the § 3.9 host read, left standing)
    n = int(valid.sum())
    # repro-torch-lint: disable=RPT002 (the § 3.9 host read, left standing)
    if not bool(valid[:n].all()):
        order = torch.sort((~mask).to(torch.uint8), stable=True).indices
        kc, vc = kc.index_select(1, order), vc.index_select(1, order)
    return kc, vc, n


def decode_attention(x, p, cfg: ModelConfig, cache: KVCache, cur_len: int, window: int = 0,
                     kernel: bool = True):
    """One-token attention against the cache.  x: (B, 1, D); ``cur_len``:
    the absolute position of the new token, written at slot ``cur_len %
    cache_len`` in place, and the reference's mask over the cache's
    positions, ``0 <= pos <= cur_len`` (and ``pos > cur_len - window`` when
    the window is positive).

    Without a window, on the kernel route, K4 reads the first
    ``min(cur_len + 1, cache_len)`` slots, which is the mask when the cache
    was filled by a prefill of s tokens and the decode steps at s, s + 1,
    ..., cur_len after it (the engine's use).  Proof, L = cache_len: every
    write stores a position at most cur_len and at least 0, so a slot is
    masked out exactly when it still holds -1.  If s >= L, the prefill
    wrote all L slots, so all are valid, and cur_len >= s >= L gives L =
    min(cur_len + 1, L).  If s < L, the prefill wrote slots 0..s-1 and the
    step at position p writes slot p % L, which is p while p < L; so while
    cur_len < L the written slots are exactly 0..cur_len, a prefix of
    cur_len + 1, and once cur_len >= L the steps s..L-1 have written the
    rest, so all L are valid.  In both cases the valid slots are the first
    min(cur_len + 1, L)."""
    cd = cfg.compute_dtype
    b = x.shape[0]
    cur_len = int(cur_len)
    cache_len = cache.k.shape[1]
    slot = cur_len % cache_len
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(x, p, cd)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    store_rows(cache.k, 1, slot, k)
    store_rows(cache.v, 1, slot, v)
    fill_rows(cache.pos, 0, slot, slot + 1, cur_len)
    kc, vc = cache.k.to(cd), cache.v.to(cd)
    if _kernel_route(x, kernel):
        mask = _decode_mask(cache.pos, cur_len, window) if window > 0 else None
        out = _decode_kernel(q[:, 0], kc, vc, min(cur_len + 1, cache_len), mask)[:, None]
    else:
        mask = _decode_mask(cache.pos, cur_len, window)
        q, ke, ve = constrain_attention_decode(q, _expand_kv(kc, cfg.n_heads),
                                               _expand_kv(vc, cfg.n_heads))
        out = (_mesh_decode_sdpa(q, ke, ve, mask, cd) if is_dtensor(q)
               else _sdpa(q, ke, ve, mask[None, None, None, :], cd))
    return _out(out, p["wo"], cd), cache


def _kernel_kv(kc, vc, placements):
    """This rank's blocks of the cache, laid out as ``placements``."""
    mesh = kc.device_mesh
    return kc.redistribute(mesh, placements).to_local(), vc.redistribute(mesh, placements).to_local()


def _decode_kernel(q, kc, vc, n: int, mask):
    """K4 for q (B, H, hd) over the cache kc, vc (B, S_cache, KVH, hd),
    reading its first ``n`` slots, or where ``mask`` (a windowed layer's
    valid slots) is given, those (:func:`_ring_slots`).  On ``DTensor`` s,
    on each rank's batch rows and heads with every slot whole."""
    b, cache_len = q.shape[0], kc.shape[1]
    placements = None
    if is_dtensor(q):
        placements = _heads_placements(kc.placements, kc.device_mesh, 2,
                                       (q.shape[1], kc.shape[2]))
        q_placements = _heads_placements(kc.placements, kc.device_mesh, 1,
                                         (q.shape[1], kc.shape[2]))
        like = q
        q = q.redistribute(q.device_mesh, q_placements).to_local()
        kc, vc = _kernel_kv(kc, vc, placements)
        mask = None if mask is None else mask.full_tensor()
        b = q.shape[0]
    if mask is not None:
        kc, vc, n = _ring_slots(kc, vc, mask)
    lengths = torch.full((b,), n, dtype=torch.int32, device=q.device)
    out = ops.decode_attention(q, kc, vc, lengths, block_k=cache_len)
    if placements is None:
        return out
    return from_block(out, like.device_mesh, q_placements, like.shape)
