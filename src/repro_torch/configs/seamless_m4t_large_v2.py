"""seamless-m4t-large-v2 [audio]: enc-dec, multimodal [arXiv:2308.11596; hf].

The speech frontend (w2v-BERT feature extractor) is a STUB: ``input_specs``
provides precomputed frame embeddings (B, frames, d_model).  24 encoder +
24 decoder layers (the assigned 24L is the per-stack depth).
"""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        n_layers=48,             # 24 enc + 24 dec
        n_enc_layers=24,
        n_dec_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        head_dim=64,
        act="gelu",
        frontend="audio_stub",
        rope_theta=10_000.0,
    ),
    reduced=ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        n_layers=4,
        n_enc_layers=2,
        n_dec_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        act="gelu",
        frontend="audio_stub",
    ),
)
