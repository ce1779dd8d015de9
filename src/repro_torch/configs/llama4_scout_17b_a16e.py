"""llama4-scout-17b-a16e [moe]: 16 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        head_dim=128,
        n_experts=16,
        top_k=1,
        moe_d_ff=8192,
        rope_theta=500_000.0,
    ),
    reduced=ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        n_experts=4,
        top_k=1,
        moe_d_ff=128,
    ),
)
