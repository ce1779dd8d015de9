"""deepseek-67b [dense]: llama-arch GQA [arXiv:2401.02954; hf]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-67b",
        family="dense",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        head_dim=128,
        rope_theta=10_000.0,
    ),
    reduced=ModelConfig(
        name="deepseek-67b",
        family="dense",
        n_layers=3,
        d_model=96,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        head_dim=24,
    ),
)
