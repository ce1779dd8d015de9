"""Model / run configuration dataclasses and the architecture registry.

The port of ``repro.configs.base``: the same fields and registry, with
torch dtypes for the reference's jnp ones (``param_dtype`` float32,
``compute_dtype`` and ``kv_cache_dtype`` bfloat16, as in the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0           # 0 -> d_ff
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    window: int = 0             # sliding attention window; 0 = full attention
    slstm_every: int = 0        # xLSTM: every k-th layer is an sLSTM block

    # encoder-decoder
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # modality frontends (STUBS: input_specs provides embeddings directly)
    frontend: str = "none"      # none | vision_stub | audio_stub
    n_frontend_tokens: int = 0

    # misc
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    act: str = "silu"           # silu | gelu
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    attn_chunk: int = 0         # chunked linear-recurrence chunk size (SSM)

    # numerics
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    # training substrate knobs (hillclimbing levers)
    remat: str = "full"         # none | dots | full
    kv_cache_dtype: Any = torch.bfloat16   # float8 would halve decode traffic
    scan_layers: bool = True
    sp_decode: bool = False     # shard the KV cache along sequence over 'model'
    local_attention: bool = False  # banded chunked attention for window > 0
    seq_parallel: bool = False  # Megatron-SP residual stream: S over 'model'
                                # between blocks (all-reduce -> RS + AG)
    fsdp_only: bool = False     # no TP: params sharded over BOTH mesh axes,
                                # batch over both axes (for models whose
                                # d_model is too small for TP=16)
    serve_weight_dtype: Any = None  # cast weights for serving bundles
                                    # (bfloat16 halves decode weight traffic)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.moe_d_ff == 0 and self.n_experts:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode a 500k context without a full-attention KV?"""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, ModelConfig] = {}
_REDUCED: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, reduced: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _REDUCED[cfg.name] = reduced
    return cfg


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(table)}")
    return table[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) cells, honouring the long_500k sub-quadratic skip."""
    _ensure_loaded()
    cells = []
    for arch in sorted(_REGISTRY):
        cfg = _REGISTRY[arch]
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.subquadratic:
                continue  # full-attention archs skip 500k decode (DESIGN.md)
            cells.append((arch, shape.name))
    return cells


def _ensure_loaded() -> None:
    """Register the configs ported so far: the four dense ones.  The other
    six of the reference (hymba-1.5b, llama4-scout, paligemma, qwen3-moe,
    seamless-m4t, xlstm) wait for their families (ROADMAP.md, Queue 1
    item 11)."""
    if _REGISTRY:
        return
    from . import (  # noqa: F401  (import side effect: registration)
        command_r_plus_104b,
        deepseek_67b,
        llama3_2_1b,
        yi_9b,
    )
