"""K3: flash attention (causal / sliding-window / full, GQA) as a CUDA kernel
for Hopper.

The port of ``repro.kernels.flash_attention`` (the Pallas TPU kernel
``_flash_kernel``), in the reference's (B, S, H, hd) layout.  Routes split
by device, never by failure: a CUDA tensor launches K3
(``csrc/flash_attention.cu``, built at first use, see
:mod:`repro_torch.kernels._build`) and raises if it cannot; a CPU tensor
runs :func:`flash_attention_plain`, which is also the kernel's oracle on the
card.  :data:`flash_launches` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import torch

from ..obs.telemetry import get_telemetry

DEFAULT_BQ = 512
DEFAULT_BK = 512
NEG_INF = -1e30

#: element types K3 loads (q, k, v and the output share one); ids of its C interface
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: head dims K3 and K4 have instances for
HEAD_DIMS = (64, 128, 256)

#: K3's instances: the element type picks the kernel of ``csrc/flash_attention.cu``
#: (``flash_wgmma_kernel`` on the tensor cores, ``flash_kernel`` on the CUDA
#: cores) and the head dim its tiles, as (query rows, keys) per block
INSTANCES = {
    torch.bfloat16: ("flash_wgmma_kernel", {64: (128, 128), 128: (128, 128), 256: (128, 32)}),
    torch.float16: ("flash_wgmma_kernel", {64: (128, 128), 128: (128, 128), 256: (128, 32)}),
    torch.float32: ("flash_kernel", {64: (64, 64), 128: (64, 64), 256: (64, 64)}),
}

#: K3 launches since import (or since a caller reset it); the plain version
#: on CPU tensors never counts
flash_launches = 0


def _check(q, k, v, block_q, block_k, causal, window):
    """The reference's shape contract, and its rejection of blocks that do
    not divide the lengths, as ``ValueError`` on both routes.  K and V may
    be longer or shorter than q (cross-attention) only without a mask."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"need q (B, S, H, hd) and k, v (B, S_kv, KVH, hd), got {tuple(q.shape)}, "
            f"{tuple(k.shape)} and {tuple(v.shape)}")
    B, S, H, hd = q.shape
    S_kv = k.shape[1]
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k and v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if S_kv != S and (causal or window > 0):
        raise ValueError(f"k and v {tuple(k.shape)} do not fit q {tuple(q.shape)}: a causal "
                         "or windowed call needs as many keys as queries")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"{H} query heads do not split into groups of {k.shape[2]} kv heads")
    bq, bk = min(block_q, S), min(block_k, S_kv)
    if bq < 1 or bk < 1 or S % bq or S_kv % bk:
        raise ValueError(f"S = {S} or S_kv = {S_kv} is not a multiple of the blocks "
                         f"({bq}, {bk})")


def k3_instance(dtype, hd):
    """``(kernel, (query rows, keys))``: the K3 kernel that runs q, k and v of
    ``dtype`` at head dim ``hd``, and its tiles.  bf16 and fp16 run on the
    tensor cores, float32 on the CUDA cores (TF32 would break its 2e-5
    tolerance); ``ValueError`` for a type or head dim with no instance, as
    the C entry point returns ``cudaErrorInvalidValue`` for them."""
    if dtype not in INSTANCES:
        raise ValueError(f"K3 takes one of {list(INSTANCES)} for q, k and v, got {dtype}")
    kernel, tiles = INSTANCES[dtype]
    if hd not in tiles:
        raise ValueError(f"K3 has no instance for head dim {hd}; it takes {HEAD_DIMS}")
    return kernel, tiles[hd]


def aligned(t):
    """``t`` contiguous, and at a 16-byte aligned address (the kernels'
    TMA loads and 16-byte copies need it; a view may start anywhere in its
    storage)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def refuse_autograd(kernel: str, *tensors) -> None:
    """``RuntimeError`` naming ``kernel`` when autograd would need it: grad
    is enabled and a floating input requires grad.  The kernels write their
    output through a raw pointer, so it has no ``grad_fn``, and a backward
    pass would silently give the inputs no gradient; the reference has no
    backward kernel either.  Differentiate the plain route (the models'
    ``kernel=False``), or call under ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad and t.is_floating_point() for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward pass: an input requires grad with grad enabled; "
            "take gradients through the plain route (kernel=False) or call it under "
            "torch.no_grad()")


def _mask(S, S_kv, causal, window, device):
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(S_kv, device=device)[None, :]
    mask = torch.ones((S, S_kv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None):
    """The plain PyTorch version of K3's function: scores in float32 for
    each query-head group against its kv head (no repeat of k or v), masked
    scores set to -1e30, probabilities zeroed by the mask, and
    ``(P V) / max(l, 1e-30)`` cast to q's type."""
    B, S, H, hd = q.shape
    S_kv, kvh = k.shape[1], k.shape[2]
    rep = H // kvh
    scale = hd ** -0.5 if scale is None else scale
    qg = q.float().reshape(B, S, kvh, rep, hd).permute(0, 2, 3, 1, 4).reshape(
        B, kvh, rep * S, hd)
    kf = k.float().permute(0, 2, 1, 3)                      # (B, KVH, S_kv, hd)
    vf = v.float().permute(0, 2, 1, 3)
    s = torch.matmul(qg, kf.transpose(-1, -2)).view(B, kvh, rep, S, S_kv) * scale
    mask = _mask(S, S_kv, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.view(B, kvh, rep * S, S_kv), vf).view(B, kvh, rep, S, hd) / denom
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, window=0, scale=None, block_q=DEFAULT_BQ,
                    block_k=DEFAULT_BK):
    """Attention of q (B, S, H, hd) over k, v (B, S_kv, KVH, hd), H a
    multiple of KVH: causal (key j <= query i), sliding-window (j > i -
    window, when ``window > 0``), both, or full; ``scale`` defaults to
    hd ** -0.5.  Returns (B, S, H, hd) in q's type.  S_kv may differ from S only
    in a full call (cross-attention: every query over every key), or
    ``ValueError``; the reference's kernel takes S_kv == S alone.

    ``block_q`` and ``block_k`` are the reference's tile sizes: S must be a
    multiple of ``min(block_q, S)`` and S_kv of ``min(block_k, S_kv)``, or
    ``ValueError``, but they do not change the result.  K3 picks its own
    tiles (:func:`k3_instance`): bf16 and fp16 run on the tensor cores in
    blocks of 128 query rows against key tiles of 128 (32 at head dim 256);
    float32 runs on the CUDA cores, 64 query rows by 64 keys.

    CUDA tensors launch K3 (float32, bf16 or fp16, one type for q, k and v;
    head dim 64, 128 or 256) and count in :data:`flash_launches`; CPU
    tensors run :func:`flash_attention_plain`.  K3 is forward-only: its
    route raises ``RuntimeError`` (:func:`refuse_autograd`) where autograd
    would need a gradient through it.
    """
    window = max(int(window), 0)
    _check(q, k, v, block_q, block_k, causal, window)
    if not kernel_route(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    refuse_autograd("flash_attention (kernel K3)", q, k, v)
    return _launch(q, k, v, causal, window, scale)


def kernel_route(t) -> bool:
    """Whether a call on ``t`` takes the kernel's route: every tensor but a
    CPU one (which runs the plain version)."""
    return t.device.type != "cpu"


def _launch(q, k, v, causal, window, scale):
    """K3 on the card: the checks of its C interface, then one launch."""
    global flash_launches
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {dev}, "
                         f"{k.device} and {v.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"K3 takes one type for q, k and v, got {q.dtype}, {k.dtype} and "
                         f"{v.dtype}")
    B, S, H, hd = q.shape
    k3_instance(q.dtype, hd)
    from ._build import load_attention

    lib = load_attention()
    q, k, v = aligned(q), aligned(k), aligned(v)
    out = torch.empty_like(q)
    if out.numel():
        scale = hd ** -0.5 if scale is None else scale
        with torch.cuda.device(dev):
            err = lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, k.shape[1], H, k.shape[2], hd, DTYPE_IDS[q.dtype], int(bool(causal)),
                window, float(scale), torch.cuda.current_stream(dev).cuda_stream,
            )
        if err:
            raise RuntimeError("flash_attention: K3 launch failed: "
                               + lib.repro_attention_error_string(err).decode())
        flash_launches += 1
        get_telemetry().count("kernels/flash_attention_launches")
    return out
