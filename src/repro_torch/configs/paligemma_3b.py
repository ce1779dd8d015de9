"""paligemma-3b [vlm]: SigLIP + gemma [arXiv:2407.07726; hf].

The SigLIP vision tower is a STUB: ``input_specs`` provides precomputed patch
embeddings (B, 256, d_model); a trainable projection fuses them with text.
"""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        d_ff=16384,
        vocab_size=257216,
        head_dim=256,
        act="gelu",
        frontend="vision_stub",
        n_frontend_tokens=256,
        rope_theta=10_000.0,
        tie_embeddings=True,
    ),
    reduced=ModelConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        head_dim=32,
        act="gelu",
        frontend="vision_stub",
        n_frontend_tokens=8,
        tie_embeddings=True,
    ),
)
