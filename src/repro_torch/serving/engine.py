"""Per-replica inference engine: prefill + decode with a slot-based cache.

The port of ``repro.serving.engine``.  One engine == one replica.  Sessions
are admitted in rolling batches and decoded greedily in lockstep; the
cluster layer (and the paper's autoscaler) handles everything across
replicas.  It runs eagerly, under ``torch.inference_mode()``, with no jit
and no CUDA graph: on the card each prefill is one launch of kernel K3 per
attention layer and each decode step two of K4 (its split pass and merge)
per attention layer, among the matrix products and elementwise launches
around them; xLSTM has no attention layer and launches neither.  The
encoder-decoder's prefill runs K3 in each encoder layer and twice in each
decoder layer (self- and cross-attention), and its decode step K4 twice
per decoder layer.

The modality stubs get the reference's inputs: zeros in bf16, (B,
n_frontend_tokens, D) image embeddings before the prompt (vlm; the decode
steps' positions count them) or (B, S, D) source frames (encoder-decoder,
with a cross cache of S rows).  As in the reference, ``max_seq`` is checked
against the prompt and the new tokens alone: a vlm stream whose image
tokens take it past ``max_seq`` overflows its cache (ROADMAP.md § 3.10).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.provision import _resolve_device
from ..models import decode_fn, init_cache, prefill_fn

#: the layer weights that the reference casts to the compute dtype on every
#: call (``p[...].astype(cd)``); the engine casts them once: attention and
#: MLP (and MoE's experts, whose names they share), the SSM's and mLSTM's,
#: and the modality stub's projection.  What the reference reads in float32
#: stays: MoE's ``router``, sLSTM's ``w_in``, ``r_in`` and ``bias``, the
#: SSM's ``a_log`` and ``d_skip``
_MATRICES = ("wq", "wk", "wv", "wo", "wi", "wg", "in_proj", "out_proj", "conv", "wbc", "wdt",
             "dt_bias", "wif", "if_bias", "frontend_proj")


@dataclasses.dataclass
class GenerationResult:  # repro-lint: disable=RPL005
    tokens: np.ndarray          # (B, n_new)
    prefill_len: int


def serving_params(params: dict, cfg: ModelConfig, device) -> dict:
    """``params`` on ``device`` with the :data:`_MATRICES` in the compute
    dtype: the copies the reference makes on every call, made once.
    The cast is deterministic, so every product sees the same bits.  The
    embedding table (gathered, then cast, per token; unembedded in float32)
    and the norms' scales (read in float32) keep their dtype.  A tensor
    already of that device and dtype is kept, not copied, so engines built
    from one ``serving_params`` result share its weights."""

    def cast(name, tree):
        if isinstance(tree, dict):
            return {k: cast(k, v) for k, v in tree.items()}
        if isinstance(tree, list):          # the layers: blocks, encoder, decoder
            return [cast(name, v) for v in tree]
        return tree.to(device=device, dtype=cfg.compute_dtype if name in _MATRICES
                       else tree.dtype)

    return cast(None, params)


class InferenceEngine:
    """Greedy-decoding engine on ``device`` (the card unless given
    ``"cpu"``; without CUDA the default raises).

    ``kernel=False`` runs the reference's einsum attention on the card in
    place of K3 and K4: the oracle of the kernel route, for checks only.
    """

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 4, max_seq: int = 256,
                 device="cuda", *, kernel: bool = True):
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
                  keep_logits: bool = False, frontend: torch.Tensor | None = None):
        """``generate``'s loop: the (B, n_new) greedy picks as numpy, and,
        under ``keep_logits``, the float32 logits of the prefill and of each
        decode step on the device.  ``forced`` (B, n_new) feeds its tokens
        to the decode steps in place of the picks, so that two engines can
        be compared step by step on the same inputs; ``frontend`` replaces
        the stub's zeros, so that checks can feed it values that a wrong
        position or a dropped cross-attention would show in."""
        cfg = self.cfg
        B, S = tokens.shape
        if B > self.max_batch or S + n_new > self.max_seq:
            raise ValueError(f"a batch of {B} prompts of {S} tokens plus {n_new} new ones "
                             f"exceeds max_batch={self.max_batch}, max_seq={self.max_seq}")
        logits_seen = []
        with torch.inference_mode():
            cache = init_cache(cfg, B, self.max_seq, src_len=S, device=self.device)
            batch = {"tokens": torch.as_tensor(np.asarray(tokens, np.int32), device=self.device)}
            prefix = S
            if cfg.frontend != "none":
                rows = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else S
                batch["frontend"] = (torch.zeros((B, rows, cfg.d_model), dtype=torch.bfloat16,
                                                 device=self.device)
                                     if frontend is None else frontend.to(self.device))
                if cfg.frontend == "vision_stub":
                    prefix += batch["frontend"].shape[1]
            logits, cache = self._prefill(self.params, batch, cache)
            picks = [torch.argmax(logits, dim=-1).to(torch.int32)]
            feed = None if forced is None else torch.as_tensor(
                np.asarray(forced, np.int32), device=self.device)
            for i in range(n_new - 1):
                if keep_logits:
                    logits_seen.append(logits)
                tok = picks[-1] if feed is None else feed[:, i]
                logits, cache = self._decode(self.params, tok, prefix + i, cache)
                picks.append(torch.argmax(logits, dim=-1).to(torch.int32))
            if keep_logits:
                logits_seen.append(logits)
            out = torch.stack(picks, dim=1).cpu().numpy()
        return out, logits_seen
