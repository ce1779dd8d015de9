"""The public attention wrappers, with ``repro.kernels.ops``'s signatures
and defaults.

There is no jit and no interpret flag: the device of the tensors picks the
route.  CUDA tensors launch K3 or K4 (and raise if they cannot); CPU
tensors run their plain PyTorch versions.  Both kernels are forward-only, as
the reference's are: on their route a call with grad enabled and an input
that requires grad raises ``RuntimeError`` naming the kernel, instead of
returning an output with no gradient path.
"""
from __future__ import annotations

from .decode_attention import decode_attention as _decode
from .flash_attention import flash_attention as _flash


def flash_attention(q, k, v, *, causal=True, window=0, block_q=512, block_k=512):
    """:func:`repro_torch.kernels.flash_attention.flash_attention` at the
    default scale hd ** -0.5."""
    return _flash(q, k, v, causal=causal, window=window, block_q=block_q, block_k=block_k)


def decode_attention(q, k_cache, v_cache, lengths, *, block_k=1024):
    """:func:`repro_torch.kernels.decode_attention.decode_attention` at the
    default scale hd ** -0.5."""
    return _decode(q, k_cache, v_cache, lengths, block_k=block_k)
