"""hymba-1.5b [hybrid]: parallel attention + Mamba heads [arXiv:2411.13676; hf].

Adaptation note (DESIGN.md): all attention layers use a sliding window (2048)
so the hybrid SSM state carries global context; the published model keeps 3
full-attention layers.  This keeps the 500k-decode KV cache O(window).
"""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        head_dim=64,
        ssm_state=16,
        window=2048,
        attn_chunk=256,
        rope_theta=10_000.0,
    ),
    reduced=ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        ssm_state=8,
        window=16,
        attn_chunk=8,
    ),
)
