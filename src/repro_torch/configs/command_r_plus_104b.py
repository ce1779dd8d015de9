"""command-r-plus-104b [dense]: GQA, no-bias
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=33792,
        vocab_size=256000,
        head_dim=128,
        rope_theta=75_000_000.0,
        tie_embeddings=True,
    ),
    reduced=ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        head_dim=16,
        tie_embeddings=True,
    ),
)
