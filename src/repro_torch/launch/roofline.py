"""Roofline aggregation: dry-run artifacts -> per-cell three-term analysis.

Terms (per step, single-pod 16x16 = 256 ranks, H100 constants):

  compute_s    = traced FLOPs per rank / 989e12          [exact: full-depth trace]
  memory_s     = fused HBM traffic model / 3.35e12        [analytic, see below]
  collective_s = traced collective bytes per rank / 50e9  [exact: the trace's]

The dry-run counts no unfused traffic, so the memory term uses an explicit
traffic model:

  train:   4 weight passes (fwd + remat + bwd, incl. FSDP gather buffers) at
           TP sharding + grad traffic + fp32 Adam state r/w (ZeRO over all
           chips) + 2x layer-boundary activations + 2x loss-chunk logits
  prefill: 1 weight pass + KV-cache write + 4x one-pass activations
  decode:  1 active-weight pass + full KV-cache/state read + logits

MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / 2*N_active*B (decode) with
N excluding embeddings; the ratio MODEL_FLOPS/traced FLOPs exposes remat
and redundant compute.  An analytic correction is added for the ssm family's
sLSTM R-matmul, as the reference adds it.

The port of ``repro.launch.roofline``, with the reference's traffic model
and formulas.  Its TPU v5e constants become the H100's, named here once:
:data:`PEAK_FLOPS_BF16` and :data:`HBM_BW` from the H100 SXM5 data sheet
(dense bf16 tensor cores; HBM3), :data:`PEAK_FLOPS_F32` (float32 outside
the tensor cores) from the same sheet, and :data:`LINK_BW`, the one
collective constant as in the reference: 50e9 B/s per GPU, one 400 Gb/s
NDR InfiniBand port per GPU, since a 16-rank ``"model"`` axis spans two
8-GPU nodes.  Dtype sizes come from torch.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..configs import SHAPES, get_config
from ..models import model_zoo as zoo

PEAK_FLOPS_BF16 = 989e12          # per GPU, H100 SXM5, dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12            # per GPU, H100 SXM5, float32 outside the tensor cores
HBM_BW = 3.35e12                  # bytes/s per GPU, H100 SXM5 HBM3
LINK_BW = 50e9                    # bytes/s per GPU: one 400 Gb/s NDR InfiniBand port


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def cell_facts(arch: str, shape_name: str, mesh: str,
               overrides: dict | None = None) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    n_chips = 512 if mesh == "2x16x16" else 256
    tp = 16
    dp = n_chips // tp
    n_total = zoo.param_count(cfg)
    n_embed = zoo.embedding_param_count(cfg)
    n_active = zoo.active_param_count(cfg)
    body = n_total - n_embed
    body_active = n_active - n_embed
    B, S = shape.global_batch, shape.seq_len
    b_loc = max(B // dp, 1)
    return dict(
        cfg=cfg, shape=shape, n_chips=n_chips, tp=tp, dp=dp,
        n_total=n_total, n_embed=n_embed, n_active=n_active,
        body=body, body_active=body_active, B=B, S=S, b_loc=b_loc,
    )


def model_flops(f: dict) -> float:
    """Global 'useful' FLOPs per step: 6ND / 2ND / 2*N_active*B."""
    kind = f["shape"].kind
    tokens = f["B"] * f["S"]
    n = f["body_active"] + f["n_embed"] / 2  # unembed matmul counts, gather not
    if kind == "train":
        return 6.0 * n * tokens
    if kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * f["B"]                   # decode: one token per sequence


def analytic_memory_bytes(f: dict) -> float:
    """Per-device fused HBM traffic per step (model described above)."""
    cfg, shape = f["cfg"], f["shape"]
    kind = shape.kind
    tp, chips = f["tp"], f["n_chips"]
    D = cfg.d_model
    L = cfg.n_layers
    tokens_loc = f["b_loc"] * f["S"]
    serve_bytes = (
        _itemsize(cfg.serve_weight_dtype)
        if getattr(cfg, "serve_weight_dtype", None) is not None else 2.0
    )
    w_bf16 = 2.0 * f["n_total"]
    w_active = serve_bytes * f["n_active"]

    if kind == "train":
        weights = 4.0 * w_bf16 / tp
        grads = 2.0 * w_bf16 / tp
        adam = 6.0 * 4.0 * f["n_total"] / chips
        acts = 4.0 * L * tokens_loc * D * 2.0
        logits = 2.0 * tokens_loc * (cfg.vocab_size / tp) * 4.0
        return weights + grads + adam + acts + logits
    if kind == "prefill":
        weights = w_bf16 / tp
        cache = 2.0 * f["b_loc"] * min(f["S"], _cache_len(cfg, f["S"])) \
            * cfg.n_kv_heads * cfg.head_dim * 2.0
        acts = 4.0 * L * tokens_loc * D * 2.0
        return weights + cache * L + acts
    # decode
    weights = w_active / tp
    cache = _decode_state_bytes(cfg, f)
    logits = f["b_loc"] * (cfg.vocab_size / tp) * 4.0
    return weights + cache + logits


def _cache_len(cfg, S: int) -> int:
    if cfg.family == "hybrid" and cfg.window:
        return min(cfg.window, S)
    if cfg.family == "ssm":
        return 0
    return S


def _decode_state_bytes(cfg, f: dict) -> float:
    """Per-device bytes read per decode step: KV caches + recurrent states.
    The audio family's cross cache is counted at 4096 frames, the fixed
    memory of its decode cells, as in the reference."""
    b = f["b_loc"]
    L = cfg.n_layers
    total = 0.0
    clen = _cache_len(cfg, f["S"])
    cache_bytes = _itemsize(cfg.kv_cache_dtype)
    if cfg.n_kv_heads % f["tp"] == 0:
        kv_shard = f["tp"]
    elif getattr(cfg, "sp_decode", False) and clen and clen % f["tp"] == 0:
        kv_shard = f["tp"]          # sequence-sharded cache
    else:
        kv_shard = 1
    if clen:
        total += 2.0 * b * clen * cfg.n_kv_heads * cfg.head_dim * cache_bytes \
            / kv_shard * (L if cfg.family != "audio" else cfg.n_dec_layers)
    if cfg.family == "hybrid":
        di = cfg.ssm_expand * cfg.d_model
        nh = di // cfg.head_dim
        total += 4.0 * b * nh * cfg.ssm_state * cfg.head_dim * L  # fp32 state
    if cfg.family == "ssm":
        di = cfg.ssm_expand * cfg.d_model
        nh, hd = cfg.n_heads, di // cfg.n_heads
        total += 4.0 * b * nh * hd * (hd + 1) * L                 # mLSTM matrix
    if cfg.family == "audio":
        total += (2.0 * b * 4096 * cfg.n_kv_heads * cfg.head_dim
                  * cache_bytes * cfg.n_dec_layers)
    return total


def slstm_correction_flops(f: dict) -> float:
    """Per-device flops of sLSTM's in-scan R matmul (train/prefill), which
    the reference's cost analysis counts once; added as the reference adds
    it, so that the two tables compare."""
    cfg = f["cfg"]
    if cfg.family != "ssm" or not cfg.slstm_every:
        return 0.0
    if f["shape"].kind == "decode":
        return 0.0
    di = cfg.ssm_expand * cfg.d_model
    nh, hd = cfg.n_heads, di // cfg.n_heads
    n_slstm = cfg.n_layers // cfg.slstm_every
    per_step = 2.0 * nh * hd * 4 * hd
    passes = 3.0 if f["shape"].kind == "train" else 1.0
    total = passes * n_slstm * per_step * f["B"] * f["S"]
    return total / f["n_chips"]


def analyse(report: dict, overrides: dict | None = None) -> dict:
    f = cell_facts(report["arch"], report["shape"], report["mesh"], overrides)
    hlo_flops = report["hlo_flops_per_device"] + slstm_correction_flops(f)
    mem_bytes = analytic_memory_bytes(f)
    coll = report["collective_total_per_device"]
    compute_s = hlo_flops / PEAK_FLOPS_BF16
    memory_s = mem_bytes / HBM_BW
    collective_s = coll / LINK_BW
    mf = model_flops(f)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    useful_frac = mf / (hlo_flops * f["n_chips"]) if hlo_flops else 0.0
    # roofline fraction: useful work per second at the bound vs peak
    mfu_at_bound = (mf / f["n_chips"] / bound_s) / PEAK_FLOPS_BF16 if bound_s else 0.0
    return dict(
        arch=report["arch"], shape=report["shape"], mesh=report["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        memory_s_hlo_upper=report["roofline"].get(
            "memory_s_hlo_upper", report["roofline"].get("memory_s")
        ),
        dominant=dominant, model_flops=mf,
        hlo_flops_total=hlo_flops * f["n_chips"],
        useful_frac=useful_frac, roofline_frac=mfu_at_bound,
        collectives=report["collective_bytes_per_device"],
        temp_bytes=report["bytes_per_device"]["temp"],
        arg_bytes=report["bytes_per_device"]["argument"],
    )


def comment(a: dict) -> str:
    """One sentence on what would move the dominant term down."""
    if a["dominant"] == "compute":
        if a["useful_frac"] < 0.3:
            return ("compute-bound with low useful fraction: cut remat "
                    "(policy=dots) and fp32 softmax/logit width")
        return "compute-bound near useful peak: only sharding wider helps"
    if a["dominant"] == "memory":
        if a["shape"] == "decode_32k" or a["shape"] == "long_500k":
            return ("cache-read bound: int8 KV cache and wider cache sharding "
                    "halve/shard the stream")
        return ("weight/activation traffic bound: fewer weight passes (remat "
                "policy), bf16 master-weight reads, larger per-device batch")
    return ("collective-bound: overlap all-gathers with compute, shard KV "
            "heads instead of replicating, or move the reduce to the smaller axis")


def write_tables(reports_dir: Path, out_md: Path | None) -> str:
    rows = []
    for p in sorted(reports_dir.glob("*.json")):
        rep = json.loads(p.read_text())
        if rep["mesh"] != "16x16":
            continue  # roofline table is single-pod per the assignment
        rows.append(analyse(rep))
    lines = [
        "| arch | shape | compute_s | memory_s | coll_s | dominant | "
        "MODEL_FLOPS | useful frac | roofline frac | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for a in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        lines.append(
            f"| {a['arch']} | {a['shape']} | {a['compute_s']:.4f} | "
            f"{a['memory_s']:.4f} | {a['collective_s']:.5f} | {a['dominant']} | "
            f"{a['model_flops']:.3e} | {a['useful_frac']:.2f} | "
            f"{a['roofline_frac']:.3f} | {comment(a)} |"
        )
    md = "\n".join(lines)
    if out_md:
        out_md.parent.mkdir(parents=True, exist_ok=True)
        out_md.write_text(md + "\n")
    return md


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reports", default="reports/dryrun")
    ap.add_argument("--out", default="reports/roofline.md")
    args = ap.parse_args(argv)
    md = write_tables(Path(args.reports), Path(args.out))
    print(md)


if __name__ == "__main__":
    main()
