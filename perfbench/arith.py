"""The yardstick's arithmetic: the useful operations and bytes of the work
from its shapes alone, and the table of published peaks.

Operations are multiply-adds counted twice.  Only the matrix products are
counted, which is what MFU counts: norms, rotary, softmax and the other
elementwise work are left out.  Attention counts the causal half of its
two products (``QK^T`` and ``PV``), which is what causal inputs need.  A
mixture-of-experts layer counts its router and the ``top_k`` experts of
every token, not the capacity padding its dispatch computes, so padding
shows as lost utilization.  The unembedding counts the last position of
each sequence alone, as the engine computes it.
"""
from __future__ import annotations

#: published dense peaks, by ``torch.cuda.get_device_name()``: NVIDIA's H100
#: SXM data sheet, bf16 on the tensor cores without sparsity, and HBM3
#: bandwidth, both at the full 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peaks(kind: str) -> dict | None:
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(kind)


def layer_flops_per_token(model: dict) -> int:
    """One layer's matrix-product operations per token, attention's scores
    and values left out (they grow with the sequence)."""
    d, h, kvh, hd = model["d_model"], model["n_heads"], model["n_kv_heads"], model["head_dim"]
    proj = 2 * d * (h + 2 * kvh) * hd + 2 * h * hd * d
    if model["family"] == "moe":
        ffn = 2 * d * model["n_experts"] + model["top_k"] * 6 * d * model["moe_d_ff"]
    else:
        ffn = 6 * d * model["d_ff"]
    return proj + ffn


def product_flops_per_token(model: dict) -> int:
    """Every layer's matrix-product operations per prompt token."""
    return model["n_layers"] * layer_flops_per_token(model)


def attention_flops(batch: int, seq: int, heads: int, head_dim: int) -> int:
    """Causal attention's two products over ``seq`` positions: half of
    ``2 * 2 * seq^2 * head_dim`` per head and sequence."""
    return 2 * batch * heads * seq * seq * head_dim


def attention_bytes(batch: int, seq: int, heads: int, kv_heads: int, head_dim: int,
                    itemsize: int = 2) -> int:
    """q, k and v read once and the output written once."""
    return batch * seq * (2 * heads + 2 * kv_heads) * head_dim * itemsize


def prefill_flops(model: dict, batch: int, seq: int) -> int:
    """The useful operations of one prefill of ``batch`` prompts of ``seq``
    tokens: the layers' products, attention, and the unembedding of the
    last position."""
    attn = model["n_layers"] * attention_flops(batch, seq, model["n_heads"], model["head_dim"])
    return (batch * seq * product_flops_per_token(model) + attn
            + batch * 2 * model["d_model"] * model["vocab_size"])


def attention_bound_s(model: dict, batch: int, seq: int, peak: dict) -> float:
    """The least seconds one causal attention call can take on a card of
    ``peak``: its operations over the bf16 rate or its bytes over the
    memory rate, whichever is larger."""
    flops = attention_flops(batch, seq, model["n_heads"], model["head_dim"])
    nbytes = attention_bytes(batch, seq, model["n_heads"], model["n_kv_heads"],
                             model["head_dim"])
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes"])
