"""yi-9b [dense]: llama-arch GQA [arXiv:2403.04652; hf]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="yi-9b",
        family="dense",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        head_dim=128,
        rope_theta=10_000.0,
    ),
    reduced=ModelConfig(
        name="yi-9b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        head_dim=16,
    ),
)
