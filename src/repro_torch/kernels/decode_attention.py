"""K4: single-token decode attention over a long KV cache, as a CUDA kernel
for Hopper.

The port of ``repro.kernels.decode_attention`` (the Pallas TPU kernel
``_decode_kernel``).  Routes split by device, never by failure: a CUDA
tensor launches K4 (``csrc/decode_attention.cu``, built at first use, see
:mod:`repro_torch.kernels._build`) and raises if it cannot; a CPU tensor
runs :func:`decode_attention_plain`, which is also the kernel's oracle on
the card.  :data:`decode_launches` counts kernel launches, and nothing else:
a K4 call is two, the split pass and the merge of its partials.
"""
from __future__ import annotations

import torch

from ..obs.telemetry import get_telemetry
from .flash_attention import (
    DTYPE_IDS,
    HEAD_DIMS,
    NEG_INF,
    aligned,
    kernel_route,
    refuse_autograd,
)

DEFAULT_BK = 1024
#: the unit of K4's split plan: its chunks are multiples of it, and the
#: kernel's tiles (8 to 64 positions, 8 KB of K each) divide it
TILE = 64
#: blocks K4's split pass aims for on each SM
BLOCKS_PER_SM = 4

#: K4 launches since import (or since a caller reset it), two per call; the
#: plain version on CPU tensors never counts
decode_launches = 0


def _check(q, k_cache, v_cache, lengths, block_k):
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"need q (B, H, hd) and caches (B, S, KVH, hd), got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    B, S, kvh, hd = k_cache.shape
    if q.shape[0] != B or q.shape[2] != hd:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q {tuple(q.shape)}")
    if kvh < 1 or q.shape[1] % kvh:
        raise ValueError(f"{q.shape[1]} query heads do not split into groups of {kvh} kv heads")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    bk = min(block_k, S)
    if bk < 1 or S % bk:
        raise ValueError(f"S = {S} is not a multiple of block_k = {bk}")


def decode_attention_plain(q, k_cache, v_cache, lengths, *, scale=None):
    """The plain PyTorch version of K4's function: float32 scores of each
    query-head group against its kv head (no repeat of the cache), positions
    at or past ``lengths[b]`` masked to -1e30 with probability 0, and
    ``(P V) / max(l, 1e-30)`` cast to q's type — zeros for a length <= 0."""
    B, S, kvh, hd = k_cache.shape
    H = q.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    qg = q.float().reshape(B, kvh, H // kvh, hd)
    s = torch.matmul(qg, k_cache.float().permute(0, 2, 3, 1)) * scale   # (B, KVH, rep, S)
    lengths = torch.as_tensor(lengths, device=q.device)
    mask = (torch.arange(S, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v_cache.float().permute(0, 2, 1, 3)) / denom     # (B, KVH, rep, hd)
    return o.reshape(B, H, hd).to(q.dtype)


def splits(B, kvh, S, sm_count):
    """``(n_split, chunk)``: how K4 cuts the S positions of each (sequence,
    kv head) so that the split pass has about :data:`BLOCKS_PER_SM` blocks
    per SM, in chunks of whole tiles.  Fixed by the shapes, so a result
    never depends on the lengths or on timing."""
    n_tiles = -(-S // TILE)
    want = -(-BLOCKS_PER_SM * sm_count // (B * kvh))
    chunk = -(-n_tiles // max(1, min(want, n_tiles))) * TILE
    return -(-S // chunk), chunk


def decode_attention(q, k_cache, v_cache, lengths, *, scale=None, block_k=DEFAULT_BK):
    """One new token per sequence: q (B, H, hd) against caches (B, S, KVH,
    hd) of which the first ``lengths[b]`` positions are valid (a length
    above S acts as S; at or below 0 the output row is zeros, as the
    reference's kernel gives).  Returns (B, H, hd) in q's type.

    ``block_k`` is the reference's tile size: S must be a multiple of
    ``min(block_k, S)``, or ``ValueError``; it does not change the result.

    CUDA tensors launch K4 (float32, bf16 or fp16, one type for q and the
    caches; head dim 64, 128 or 256) and count two launches in
    :data:`decode_launches`; CPU tensors run :func:`decode_attention_plain`.
    K4 is forward-only: its route raises ``RuntimeError``
    (:func:`~repro_torch.kernels.flash_attention.refuse_autograd`) where
    autograd would need a gradient through it.
    """
    lengths = torch.as_tensor(lengths)
    _check(q, k_cache, v_cache, lengths, block_k)
    if not kernel_route(q):
        return decode_attention_plain(q, k_cache, v_cache, lengths.to(q.device), scale=scale)
    refuse_autograd("decode_attention (kernel K4)", q, k_cache, v_cache)
    return _launch(q, k_cache, v_cache, lengths, scale)


def _launch(q, k_cache, v_cache, lengths, scale):
    """K4 on the card: the checks of its C interface, then its two launches."""
    global decode_launches
    dev = q.device
    if dev.type != "cuda" or k_cache.device != dev or v_cache.device != dev:
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, got {dev}, "
                         f"{k_cache.device} and {v_cache.device}")
    if q.dtype not in DTYPE_IDS or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"K4 takes one of {list(DTYPE_IDS)} for q and the caches, got "
                         f"{q.dtype}, {k_cache.dtype} and {v_cache.dtype}")
    B, S, kvh, hd = k_cache.shape
    H = q.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"K4 has no instance for head dim {hd}; it takes {HEAD_DIMS}")
    from ._build import load_attention

    lib = load_attention()
    if H // kvh > lib.repro_decode_attention_max_rep(hd):
        raise ValueError(f"K4 has no instance for {H // kvh} query heads per kv head at "
                         f"head dim {hd}")
    q, k_cache, v_cache = aligned(q), aligned(k_cache), aligned(v_cache)
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel():
        n_split, chunk = splits(B, kvh, S,
                                torch.cuda.get_device_properties(dev).multi_processor_count)
        part = (B, kvh, n_split, H // kvh)
        m_part = torch.empty(part, dtype=torch.float32, device=dev)
        l_part = torch.empty(part, dtype=torch.float32, device=dev)
        acc_part = torch.empty(part + (hd,), dtype=torch.float32, device=dev)
        scale = hd ** -0.5 if scale is None else scale
        with torch.cuda.device(dev):
            err = lib.repro_decode_attention(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
                B, S, H, kvh, hd, DTYPE_IDS[q.dtype], chunk, n_split, float(scale),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err:
            raise RuntimeError("decode_attention: K4 launch failed: "
                               + lib.repro_attention_error_string(err).decode())
        decode_launches += 2
        get_telemetry().count("kernels/decode_attention_launches", 2)
    return out
