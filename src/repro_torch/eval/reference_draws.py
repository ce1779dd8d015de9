"""The reference's random streams without JAX: its eval draws, bit for bit.

The reference draws its wait uniforms with ``jax.random`` under the
Threefry-2x32 generator in its partitionable layout.  That generator is
integer arithmetic, so this module computes the same bits with PyTorch on
any device: 32-bit words are held in ``torch.int64`` tensors and masked to
32 bits after every addition and shift.  The functions keep ``jax.random``'s
names and key derivation:

* :func:`key` — ``jax.random.key(seed)``: the words ``(seed >> 32, seed &
  0xFFFFFFFF)``;
* :func:`fold_in` — Threefry over the counter ``(0, data)``;
* :func:`split` — Threefry over the counters ``(0, i)``, one key per ``i``;
* :func:`uniform` — Threefry over each entry's flat index ``(hi, lo)``, the
  two output words xored, their top 23 bits as the mantissa of a float32 in
  [1, 2), minus 1.

:class:`ReferenceDraws` is a :class:`~repro_torch.eval.harness.Draws` for
``evaluate(grid, draws=...)`` that keys the uniforms as the reference's
harness and ``_uniforms`` key them, so the port's drawn cells can be held
to the reference's report.  The reference's normals go through ``erfinv``,
whose polynomial XLA evaluates in its own order, so they are not computed
here: they are passed in (the ``(S, B, T)`` array the reference drew for
each scenario, ``tests/fixtures/ref_eval_normals_jax0.9.0.npz``), and a
shape or scenario they do not hold is an error.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF

#: Threefry-2x32's rotations, the first group and the second
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

#: the key schedule's parity constant
PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k1, k2, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` under the key words
    ``(k1, k2)``: 20 rounds.  Each argument is an int64 tensor (or int) of
    32-bit words; they broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s two words, a ``(2,)`` int64 tensor."""
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(k, data)`` of keys ``(..., 2)``."""
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], 0, data & MASK)
    return torch.stack([y0, y1], dim=-1)


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(k, n)`` of keys ``(..., 2)``: ``(..., n, 2)``."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None], 0, i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (32 bits) of keys ``(..., 2)``: an int64
    tensor ``(..., *shape)`` of words."""
    n = int(np.prod(shape))
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    k1 = k[..., 0].reshape(*lead, 1)
    k2 = k[..., 1].reshape(*lead, 1)
    y0, y1 = threefry2x32(k1, k2, i >> 32, i & MASK)
    return (y0 ^ y1).reshape(*lead, *shape)


def uniform(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` (float32 in [0, 1)) of keys
    ``(..., 2)``: ``(..., *shape)``."""
    bits = (random_bits(k, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


class ReferenceDraws:
    """The reference harness's draws for a grid of seed ``seed``.

    ``uniforms(stream, index, (B, T, N))`` keys ``fold_in(key(seed +
    stream), index)``, splits it into one key per trace and each of those
    into ``(k0, k1)``: ``(u0, u)``, each ``(B, T, N)``, drawn on ``device``.
    ``normals``: the ``(S, B, T)`` array of the reference's normals, one
    ``(B, T)`` block per scenario, returned as given (on ``device``).
    """

    def __init__(self, seed: int, normals, device="cuda"):
        self.seed = seed
        self.device = torch.device(device)
        self._normals = torch.as_tensor(np.asarray(normals, np.float32), device=self.device)
        if self._normals.dim() != 3:
            raise ValueError(f"normals must be (S, B, T), got {tuple(self._normals.shape)}")

    def normals(self, scenario_index: int, shape: tuple[int, int]) -> torch.Tensor:
        have = tuple(self._normals.shape)
        if not 0 <= scenario_index < have[0] or tuple(shape) != have[1:]:
            raise ValueError(
                f"no reference normals for scenario {scenario_index} at {tuple(shape)}: "
                f"the injected array is {have}"
            )
        return self._normals[scenario_index]

    def uniforms(self, stream: int, policy_index: int,
                 shape: tuple[int, int, int]) -> tuple[torch.Tensor, torch.Tensor]:
        b, t, n = shape
        keys = split(fold_in(key(self.seed + stream, self.device), policy_index), b)
        pair = split(keys, 2)                                   # (B, 2, 2)
        return uniform(pair[:, 0], (t, n)), uniform(pair[:, 1], (t, n))
