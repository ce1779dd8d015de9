"""Models of the port: the decoder-only LMs of the dense, vlm, moe, hybrid
and ssm families and the encoder-decoder, behind the serving engine and the
trainer."""
from .model_zoo import (
    abstract_cache,
    abstract_params,
    active_param_count,
    decode_fn,
    embedding_param_count,
    init_cache,
    init_params,
    init_served_params,
    input_specs,
    logits_fn,
    loss_fn,
    param_count,
    param_leaves,
    prefill_fn,
    served_param_bytes,
)

__all__ = [
    "abstract_cache",
    "abstract_params",
    "active_param_count",
    "decode_fn",
    "embedding_param_count",
    "init_cache",
    "init_params",
    "init_served_params",
    "input_specs",
    "logits_fn",
    "loss_fn",
    "param_count",
    "param_leaves",
    "prefill_fn",
    "served_param_bytes",
]
