"""The plain reference: the served models' prefill in float32 PyTorch, with
no kernel, cache or batching, written from the configuration's equations.

It imports nothing of ``repro_torch`` and takes nothing the program made:
it reads the weights that :mod:`perfbench.weights` drew and the prompts of
:mod:`perfbench.traffic`, and works out again every derived quantity,
the routing of a mixture-of-experts layer and its capacity ranks included.
TF32 is off while it runs.

One layer, as the configurations state it: ``x += attn(norm1(x))``, then
``x += ffn(norm2(x))``, with RMS norms scaled by ``1 + w``; attention is
causal grouped-query attention with interleaved-pair rotary embeddings on q
and k and scores at ``head_dim ** -0.5``; the dense feed-forward is
``(x Wi * silu(x Wg)) Wo``.  The expert layer follows the port's routing
rule (a departure from Qwen3, which is dropless, that the configuration
file lists): float32 router softmax, top-k, gates renormalised to sum to
1; each sequence is one routing group, its (token, choice) pairs ranked
per expert in pick order (token-major), and pairs ranked at or past the
capacity ``max(8, ceil8(int(capacity_factor * S * top_k / n_experts)))``
dropped.  The last position is normed and unembedded in float32.

``lowp=True`` is the control: every product that the configuration runs
in bf16 (the projections, attention's two products and the experts) takes
its operands rounded to float8 e4m3, each tensor scaled by its largest
magnitude (per expert for the experts' weights), the step below bf16 that
a later change could be tempted by.  The router and the unembedding stay
float32 there, as the configuration states them.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor, dims=None) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a scale that maps its largest
    magnitude (over ``dims``, all when None) to e4m3's, back in float32."""
    amax = (t.abs().amax() if dims is None else t.abs().amax(dim=dims, keepdim=True))
    scale = E4M3_MAX / amax.clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _mm(a, b, lowp: bool):
    """``a @ b``; under ``lowp`` ``a`` is rounded to e4m3 first (``b`` was
    rounded already: a weight by :func:`_weight`, or an activation by the
    caller)."""
    return (fp8(a) if lowp else a) @ b


def _weight(w: torch.Tensor, lowp: bool, dims=None) -> torch.Tensor:
    w = w.float()
    return fp8(w, dims) if lowp else w


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + scale.float())


def rope(x, theta: float):
    """Interleaved pairs (2i, 2i+1) of x (S, heads, hd) rotated by
    position * theta ** (-2i / hd)."""
    S, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def attention(h, w: dict, model: dict, lowp: bool):
    S, D = h.shape
    H, KVH, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    rep = H // KVH
    q = rope(_mm(h, w["wq"].reshape(D, H * hd), lowp).view(S, H, hd), model["rope_theta"])
    k = rope(_mm(h, w["wk"].reshape(D, KVH * hd), lowp).view(S, KVH, hd), model["rope_theta"])
    v = _mm(h, w["wv"].reshape(D, KVH * hd), lowp).view(S, KVH, hd)
    future = torch.ones((S, S), dtype=torch.bool, device=h.device).triu_(1)
    out = torch.empty((S, H, hd), dtype=torch.float32, device=h.device)
    for g in range(KVH):
        qg = q[:, g * rep:(g + 1) * rep].transpose(0, 1)               # (rep, S, hd)
        kg = fp8(k[:, g]) if lowp else k[:, g]
        s = _mm(qg, kg.t(), lowp) * hd ** -0.5
        p = torch.softmax(s.masked_fill_(future, float("-inf")), dim=-1)
        vg = fp8(v[:, g]) if lowp else v[:, g]
        out[:, g * rep:(g + 1) * rep] = _mm(p, vg, lowp).transpose(0, 1)
    return _mm(out.reshape(S, H * hd), w["wo"].reshape(H * hd, D), lowp)


def mlp(h, w: dict, lowp: bool):
    return _mm(_mm(h, w["wi"], lowp) * torch.nn.functional.silu(_mm(h, w["wg"], lowp)),
               w["wo"], lowp)


def capacity(model: dict, seq: int) -> int:
    c = int(model["capacity_factor"] * seq * model["top_k"] / model["n_experts"])
    return max(8, (c + 7) // 8 * 8)


def route(h, router, model: dict):
    """The kept (token, choice) pairs of one sequence: their pair indices
    (token-major), experts, ranks within the expert and gates."""
    E, K = model["n_experts"], model["top_k"]
    probs = torch.softmax(h @ router, dim=-1)
    gates, experts = torch.topk(probs, K, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    flat = experts.reshape(-1)
    rank = (torch.nn.functional.one_hot(flat, E).cumsum(dim=0) - 1).gather(1, flat[:, None])[:, 0]
    kept = (rank < capacity(model, h.shape[0])).nonzero()[:, 0]
    return kept, flat[kept], rank[kept], gates.reshape(-1)[kept]


def moe(h, w: dict, model: dict, lowp: bool):
    S, D = h.shape
    kept, expert, rank, gate = route(h, w["router"], model)
    token = kept // model["top_k"]
    buf = torch.zeros((model["n_experts"], capacity(model, S), D), dtype=torch.float32,
                      device=h.device)
    buf[expert, rank] = h[token]
    y = _mm(_mm(buf, w["wi"], lowp) * torch.nn.functional.silu(_mm(buf, w["wg"], lowp)),
            w["wo"], lowp)
    return torch.zeros_like(h).index_add_(0, token, y[expert, rank] * gate[:, None])


def _layer_weights(block: dict, model: dict, lowp: bool) -> tuple[dict, dict]:
    attn = {k: _weight(v, lowp) for k, v in block["attn"].items()}
    if model["family"] == "moe":
        ffn = {k: _weight(v, lowp, dims=(1, 2)) for k, v in block["moe"].items()
               if k != "router"}
        ffn["router"] = block["moe"]["router"].float()
    else:
        ffn = {k: _weight(v, lowp) for k, v in block["mlp"].items()}
    return attn, ffn


def last_logits(params: dict, model: dict, prompts, lowp: bool = False) -> list[torch.Tensor]:
    """The float32 logits (V,) of the last position of each prompt (a
    sequence of token ids), layer by layer: each layer's weights are cast
    once and applied to every prompt in turn."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        dev = params["embed"].device
        eps = model["norm_eps"]
        xs = [params["embed"][torch.as_tensor(p, device=dev).long()].float() for p in prompts]
        for block in params["blocks"]:
            attn, ffn = _layer_weights(block, model, lowp)
            for r, x in enumerate(xs):
                x = x + attention(rms_norm(x, block["ln1"], eps), attn, model, lowp)
                h = rms_norm(x, block["ln2"], eps)
                xs[r] = x + (moe(h, ffn, model, lowp) if model["family"] == "moe"
                             else mlp(h, ffn, lowp))
            del attn, ffn
        table = params["unembed"].float()
        return [(rms_norm(x[-1:], params["final_ln"], eps) @ table.t())[0] for x in xs]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
