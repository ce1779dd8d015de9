"""Models of the port: the dense decoder-only LMs behind the serving
engine (the other families of ``repro.models`` are not ported yet)."""
from .model_zoo import (
    decode_fn,
    init_cache,
    init_params,
    logits_fn,
    param_count,
    prefill_fn,
)

__all__ = [
    "decode_fn",
    "init_cache",
    "init_params",
    "logits_fn",
    "param_count",
    "prefill_fn",
]
