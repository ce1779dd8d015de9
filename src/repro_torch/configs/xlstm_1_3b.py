"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

mLSTM blocks use the chunked matrix-memory recurrence; every
``slstm_every``-th layer is a sequential sLSTM block (a loop over time).  d_ff = 0:
xLSTM blocks carry their own up/down projections (expand factor 2).
"""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        head_dim=512,
        ssm_expand=2,
        slstm_every=8,
        attn_chunk=256,
    ),
    reduced=ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        head_dim=32,
        ssm_expand=2,
        slstm_every=2,
        attn_chunk=8,
    ),
)
