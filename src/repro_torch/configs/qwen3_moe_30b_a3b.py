"""qwen3-moe-30b-a3b [moe]: 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=768,
        vocab_size=151936,
        head_dim=64,
        n_experts=128,
        top_k=8,
        moe_d_ff=768,
        rope_theta=1_000_000.0,
    ),
    reduced=ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=512,
        head_dim=16,
        n_experts=8,
        top_k=2,
        moe_d_ff=96,
    ),
)
