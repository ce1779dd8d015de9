"""llama3.2-1b [dense] [hf:meta-llama/Llama-3.2-1B; unverified]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama3.2-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        head_dim=64,
        rope_theta=500_000.0,
        tie_embeddings=True,
    ),
    reduced=ModelConfig(
        name="llama3.2-1b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        head_dim=16,
        tie_embeddings=True,
    ),
)
