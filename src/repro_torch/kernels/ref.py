"""The reference's own attention oracles, in PyTorch.

A port of ``repro.kernels.ref``: the plain softmax attention the JAX
package's tests hold its Pallas attention kernels to.  No path of the port
runs these; the tests use them to pin the reference's oracle, quirks
included: the softmax runs over ``-inf`` for masked keys, so a decode row
with ``length == 0`` comes out NaN here, while the kernels (and their plain
versions in :mod:`repro_torch.kernels.decode_attention`) give zeros.
"""
from __future__ import annotations

import torch


def _repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    return x.repeat_interleave(rep, dim=2) if rep > 1 else x


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """Causal / sliding-window / full GQA attention: q (B, S, H, hd), k and
    v (B, S, KVH, hd); computed in float32, returned in q's type."""
    S, H, hd = q.shape[1], q.shape[2], q.shape[3]
    rep = H // k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    kk, vv = _repeat_kv(k, rep), _repeat_kv(v, rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    pos = torch.arange(S, device=q.device)
    q_pos, k_pos = pos[:, None], pos[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vv.float())
    return out.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths, *, scale=None):
    """One new token per sequence: q (B, H, hd) against (B, S, KVH, hd)
    caches, of which the first ``lengths[b]`` entries are valid."""
    S, hd = k_cache.shape[1], k_cache.shape[3]
    rep = q.shape[1] // k_cache.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    kk, vv = _repeat_kv(k_cache, rep), _repeat_kv(v_cache, rep)
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), kk.float()) * scale
    lengths = torch.as_tensor(lengths, device=q.device)
    mask = torch.arange(S, device=q.device)[None, None, :] < lengths[:, None, None]
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs, vv.float())
    return out.to(q.dtype)
