"""Per-replica inference engine: prefill + decode with a slot-based cache.

The port of ``repro.serving.engine``.  One engine == one replica.  Sessions
are admitted in rolling batches and decoded greedily in lockstep; the
cluster layer (and the paper's autoscaler) handles everything across
replicas.  It runs eagerly, under ``torch.inference_mode()``, with no jit
and no CUDA graph: on the card each prefill is one launch of kernel K3 per
layer and each decode step two of K4 (its split pass and merge) per layer,
among the matrix products and elementwise launches around them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.provision import _resolve_device
from ..models import decode_fn, init_cache, prefill_fn
from ..models.blocks import require_dense

#: the layer weights that the reference casts to the compute dtype on every
#: call (``p[...].astype(cd)``); the engine casts them once
_MATRICES = ("wq", "wk", "wv", "wo", "wi", "wg")


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, n_new)
    prefill_len: int


def serving_params(params: dict, cfg: ModelConfig, device) -> dict:
    """``params`` on ``device`` with the attention and MLP matrices in the
    compute dtype: the copies the reference makes on every call, made once.
    The cast is deterministic, so every product sees the same bits.  The
    embedding table (gathered, then cast, per token; unembedded in float32)
    and the norms' scales (read in float32) keep their dtype.  A tensor
    already of that device and dtype is kept, not copied, so engines built
    from one ``serving_params`` result share its weights."""

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict)
                else v.to(device=device, dtype=cfg.compute_dtype if k in _MATRICES else v.dtype)
                for k, v in tree.items()}

    out = {k: v.to(device=device) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [cast(p) for p in params["blocks"]]
    return out


class InferenceEngine:
    """Greedy-decoding engine on ``device`` (the card unless given
    ``"cpu"``; without CUDA the default raises).

    ``kernel=False`` runs the reference's einsum attention on the card in
    place of K3 and K4: the oracle of the kernel route, for checks only.
    """

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 4, max_seq: int = 256,
                 device="cuda", *, kernel: bool = True):
        require_dense(cfg)
        self.cfg = cfg
        self.device = _resolve_device(device, "InferenceEngine")
        self.params = serving_params(params, cfg, self.device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.kernel = kernel

    def _prefill(self, params, batch, cache):
        return prefill_fn(params, self.cfg, batch, cache, kernel=self.kernel)

    def _decode(self, params, token, cur_len, cache):
        return decode_fn(params, self.cfg, token, cur_len, cache, kernel=self.kernel)

    def generate(self, tokens: np.ndarray, n_new: int) -> GenerationResult:
        """tokens: (B, S_prompt) int32. Greedy-decodes n_new tokens."""
        out, _ = self._generate(tokens, n_new)
        return GenerationResult(tokens=out, prefill_len=tokens.shape[1])

    def _generate(self, tokens: np.ndarray, n_new: int, forced: np.ndarray | None = None,
                  keep_logits: bool = False):
        """``generate``'s loop: the (B, n_new) greedy picks as numpy, and,
        under ``keep_logits``, the float32 logits of the prefill and of each
        decode step on the device.  ``forced`` (B, n_new) feeds its tokens
        to the decode steps in place of the picks, so that two engines can
        be compared step by step on the same inputs."""
        B, S = tokens.shape
        if B > self.max_batch or S + n_new > self.max_seq:
            raise ValueError(f"a batch of {B} prompts of {S} tokens plus {n_new} new ones "
                             f"exceeds max_batch={self.max_batch}, max_seq={self.max_seq}")
        logits_seen = []
        with torch.inference_mode():
            cache = init_cache(self.cfg, B, self.max_seq, device=self.device)
            batch = {"tokens": torch.as_tensor(np.asarray(tokens, np.int32), device=self.device)}
            logits, cache = self._prefill(self.params, batch, cache)
            picks = [torch.argmax(logits, dim=-1).to(torch.int32)]
            feed = None if forced is None else torch.as_tensor(
                np.asarray(forced, np.int32), device=self.device)
            for i in range(n_new - 1):
                if keep_logits:
                    logits_seen.append(logits)
                tok = picks[-1] if feed is None else feed[:, i]
                logits, cache = self._decode(self.params, tok, S + i, cache)
                picks.append(torch.argmax(logits, dim=-1).to(torch.int32))
            if keep_logits:
                logits_seen.append(logits)
            out = torch.stack(picks, dim=1).cpu().numpy()
        return out, logits_seen
