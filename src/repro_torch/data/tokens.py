"""Synthetic LM token pipeline: deterministic, seekable, dp-shardable.

A real deployment swaps this for a file-backed loader; the interface —
``batch_at(step)`` returning the globally-consistent batch for a step — is
what the fault-tolerant trainer depends on (restart at step k reproduces the
exact stream, no data loss/duplication across restarts or elastic resizes).

The port of ``repro.data.tokens``: the ids (and the modality stubs'
embeddings) come from numpy exactly as in the reference, and are handed out
as tensors on an explicit device — the card unless given ``"cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.provision import _resolve_device

_ZIPF_EXPONENT = 1.1
_zipf_cdf_cache: dict[int, np.ndarray] = {}


def _zipf_tokens(rng: np.random.Generator, vocab: int, shape: tuple) -> np.ndarray:
    """Zipf-distributed token ids: p(k) ~ 1/(k+2)^s.

    Uniform tokens carry zero learnable signal (the loss floor is log(V) and
    any training step is pure noise), so convergence tests were measuring the
    optimizer's random walk.  A Zipfian unigram stream gives the model real
    structure to learn while keeping batch_at(step) pure and seekable.
    """
    cdf = _zipf_cdf_cache.get(vocab)
    if cdf is None:
        p = 1.0 / np.power(np.arange(vocab, dtype=np.float64) + 2.0, _ZIPF_EXPONENT)
        cdf = np.cumsum(p / p.sum())
        _zipf_cdf_cache[vocab] = cdf
    # the float64 CDF endpoint can land just below 1.0, in which case a draw
    # above it would index one past the vocabulary — clamp to the last id
    ids = np.searchsorted(cdf, rng.uniform(size=shape))
    return np.minimum(ids, vocab - 1).astype(np.int64)


def make_token_batch(cfg: ModelConfig, rng: np.random.Generator, batch: int, seq: int,
                     device="cuda") -> dict:
    """One random batch, drawn on the host as the reference draws it: int32
    ``tokens`` (B, S), plus bf16 ``frontend`` embeddings for the modality
    stubs, on ``device``."""
    dev = _resolve_device(device, "make_token_batch")

    def ids(shape):
        return torch.as_tensor(_zipf_tokens(rng, cfg.vocab_size, shape).astype(np.int32),
                               device=dev)

    def embeddings(shape):
        return torch.as_tensor(rng.standard_normal(shape), device=dev).to(torch.bfloat16)

    out: dict = {}
    if cfg.frontend == "vision_stub":
        nf = cfg.n_frontend_tokens
        out["tokens"] = ids((batch, seq - nf))
        out["frontend"] = embeddings((batch, nf, cfg.d_model))
    elif cfg.frontend == "audio_stub":
        out["tokens"] = ids((batch, seq))
        out["frontend"] = embeddings((batch, seq, cfg.d_model))
    else:
        out["tokens"] = ids((batch, seq))
    return out


@dataclasses.dataclass
class TokenPipeline:
    """Deterministic step-indexed stream: batch_at(step) is pure."""

    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    device: str | torch.device = "cuda"

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        return make_token_batch(self.cfg, rng, self.batch, self.seq, self.device)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
