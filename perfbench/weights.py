"""The weights of a run, drawn by the benchmark itself from ``--seed``.

They are drawn on the run's device with a ``torch.Generator`` there, one
call for each kind of leaf with every layer's copies stacked, in the dtypes
they are served in: the layer matrices in bf16, the router, token tables
and norm scales in float32.  The tree has the layout that
``repro_torch``'s engine takes (``{"embed", "blocks": [...], "final_ln",
"unembed"}``); the same tensors go to the engine and to the reference.
Scales: matrices at fan-in ``** -0.5``, token tables at 0.02, and norm
scales ``1 + s`` with ``s`` drawn at 0.1, so that a norm that ignored its
scale would show.
"""
from __future__ import annotations

import torch


def draw(model: dict, seed: int, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    L, D, H, KVH, hd = (model[k] for k in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                                           "head_dim"))
    V = model["vocab_size"]
    bf16, f32 = torch.bfloat16, torch.float32

    def normal(shape, std, dtype):
        return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(std)

    tables = normal((2, V, D), 0.02, f32)
    norms = normal((2 * L + 1, D), 0.1, f32)
    attn = {"wq": normal((L, D, H, hd), D ** -0.5, bf16),
            "wk": normal((L, D, KVH, hd), D ** -0.5, bf16),
            "wv": normal((L, D, KVH, hd), D ** -0.5, bf16),
            "wo": normal((L, H, hd, D), (H * hd) ** -0.5, bf16)}
    if model["family"] == "moe":
        E, F = model["n_experts"], model["moe_d_ff"]
        ffn_key = "moe"
        ffn = {"router": normal((L, D, E), D ** -0.5, f32),
               "wi": normal((L, E, D, F), D ** -0.5, bf16),
               "wg": normal((L, E, D, F), D ** -0.5, bf16),
               "wo": normal((L, E, F, D), F ** -0.5, bf16)}
    else:
        F = model["d_ff"]
        ffn_key = "mlp"
        ffn = {"wi": normal((L, D, F), D ** -0.5, bf16),
               "wg": normal((L, D, F), D ** -0.5, bf16),
               "wo": normal((L, F, D), F ** -0.5, bf16)}
    blocks = [{"ln1": norms[2 * i], "ln2": norms[2 * i + 1],
               "attn": {k: w[i] for k, w in attn.items()},
               ffn_key: {k: w[i] for k, w in ffn.items()}} for i in range(L)]
    return {"embed": tables[0], "blocks": blocks, "final_ln": norms[2 * L],
            "unembed": tables[1]}
