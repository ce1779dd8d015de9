"""Serving launcher: session stream -> paper autoscaler (+ real generation).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --policy A1 --alpha 0.5 [--real-tokens] [--device cuda|cpu] \
        [--dry-run --shape decode_32k [--multi-pod]]

The port of ``repro.launch.serve``, with the reference's flags plus
``--device``.  On the card (the default) ``--real-tokens`` gives every
replica an :class:`~repro_torch.serving.InferenceEngine` of the arch at its
full width and depth, with random weights from seed 0 shared by all
replicas, running kernels K3 and K4 (xLSTM runs neither).  The weights are
drawn as the served tree (:func:`~repro_torch.models.init_served_params`:
matrices in bf16, the token tables and norms in float32), leaf by leaf, so
the float32 tree never exists.  One 80 GB card serves six of the ten archs
whole: llama3.2-1b, hymba-1.5b, seamless-m4t-large-v2, xlstm-1.3b, yi-9b
(18.71 GB served) and qwen3-moe-30b-a3b (61.43 GB).  paligemma-3b fits on
the card too, and the fit check takes it, but its 256 image tokens overflow
the 96-slot engines on every session, as in the reference (ROADMAP.md
§ 3.10), so its tokens are not the model's.  deepseek-67b (138.21 GB),
llama4-scout-17b-a16e (207.61 GB) and command-r-plus-104b (213.92 GB) need
several cards, through the sharded step builders of
:mod:`repro_torch.launch.steps`: before it allocates anything the launcher
compares what the arch needs (:func:`serving_need`) with the card's free
memory and, where it does not fit, exits 2 with both figures.  ``--device
cpu`` runs the arch's reduced config on the plain route, as the reference's
launcher does.  Without CUDA and without ``--device cpu`` it exits 2.
``--dry-run`` traces the full config's serving step for ``--shape``
(default ``decode_32k``) on the production mesh with nothing allocated
(:func:`repro_torch.launch.dryrun.run_cell`: a ``"fake"`` group of 256
ranks, or 512 with ``--multi-pod``, in this process, on the CPU) and
prints the reference's ``compiled <arch> x <shape>: flops/dev=...`` line.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

#: the engines of ``--real-tokens``: one session of up to 32 prompt and 16
#: new tokens at a time (``run_cluster``), in a cache of this many slots
ENGINE_BATCH, ENGINE_SEQ = 1, 96
#: device bytes a served model may take beyond its weights, one engine's
#: cache and the float32 draw of its largest cast leaf: the activations of
#: a session, the products' workspaces and the allocator's rounding
#: (``chip_smoke.py`` phase 22 holds the launcher's peak within it)
RESERVE_BYTES = 1 << 30


def serving_need(cfg) -> dict:
    """The device bytes ``--real-tokens`` needs for ``cfg``, from shapes
    alone: the served tree (the engines share it), the cache of one of the
    launcher's engines (:data:`ENGINE_BATCH`, :data:`ENGINE_SEQ`; the
    cluster generates one session at a time), the float32 draw of the
    largest leaf cast to the compute dtype (``init_served_params`` holds it
    while it casts), and :data:`RESERVE_BYTES`; ``"total"`` is their sum."""
    from repro_torch.models import (
        abstract_params,
        init_cache,
        param_leaves,
        served_param_bytes,
    )
    from repro_torch.models.layers import leaf_dtype

    cache = init_cache(cfg, ENGINE_BATCH, ENGINE_SEQ, src_len=ENGINE_SEQ, device="meta")
    need = {
        "weights": served_param_bytes(cfg),
        "cache": sum(x.numel() * x.element_size() for _, x in param_leaves(cache)),
        "draw": max(4 * x.numel() for name, x in param_leaves(abstract_params(cfg))
                    if leaf_dtype(cfg, name, True, x.dtype) != x.dtype),
        "reserve": RESERVE_BYTES,
    }
    need["total"] = sum(need.values())
    return need


def fit_refusal(arch: str, need: dict, free_bytes: int) -> str | None:
    """None where ``free_bytes`` of the card hold ``need`` (of
    :func:`serving_need`), else the launcher's refusal."""
    if need["total"] <= free_bytes:
        return None
    return (f"repro_torch.launch.serve: {arch} needs {need['total']:,} bytes "
            f"({need['total'] / 1e9:.2f} GB: served weights {need['weights'] / 1e9:.2f}, "
            f"cache {need['cache'] / 1e9:.2f}, draw {need['draw'] / 1e9:.2f}, reserve "
            f"{need['reserve'] / 1e9:.2f}) on one card and {free_bytes:,} bytes "
            f"({free_bytes / 1e9:.2f} GB) are free: nothing was allocated; serve it sharded "
            "across cards with the step builders of repro_torch.launch.steps")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--policy", default="A1", choices=["A1", "A2", "A3", "offline"])
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--slots", type=int, default=60)
    ap.add_argument("--concurrency", type=float, default=4.0)
    ap.add_argument("--real-tokens", action="store_true")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines run (default: the card; cpu runs the "
                         "reduced config)")
    args = ap.parse_args(argv)

    if args.dry_run:
        from pathlib import Path

        from .dryrun import run_cell

        rep = run_cell(args.arch, args.shape, args.multi_pod, Path("reports/dryrun"))
        print(f"compiled {args.arch} x {args.shape}: "
              f"flops/dev={rep['hlo_flops_per_device']:.3e}")
        return 0

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("repro_torch.launch.serve: CUDA is not available; pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config
    from repro_torch.core import CostModel
    from repro_torch.data.requests import generate_sessions
    from repro_torch.models import init_served_params
    from repro_torch.serving import InferenceEngine, make_window_max_predictor, run_cluster

    costs = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)
    trace = generate_sessions(np.random.default_rng(0), n_slots=args.slots,
                              mean_concurrency=args.concurrency)
    factory = None
    if args.real_tokens:
        cfg = get_config(args.arch, reduced=args.device == "cpu").replace(remat="none")
        if args.device == "cuda":
            refusal = fit_refusal(args.arch, serving_need(cfg), torch.cuda.mem_get_info()[0])
            if refusal is not None:
                print(refusal, file=sys.stderr)
                return 2
        # the model's float32 products (the unembedding) stay out of TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        gen = torch.Generator(device=args.device).manual_seed(0)
        params = init_served_params(cfg, gen, device=args.device)

        def factory():
            return InferenceEngine(cfg, params, max_batch=ENGINE_BATCH, max_seq=ENGINE_SEQ,
                                   device=args.device)

    rep = run_cluster(
        trace, costs, policy=args.policy, alpha=args.alpha,
        predictor=make_window_max_predictor(trace), engine_factory=factory,
        rng=np.random.default_rng(1),
    )
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"{args.policy}(alpha={args.alpha}): sessions={rep.sessions_served} "
          f"cost={rep.total_cost:,.1f} static={rep.static_cost:,.0f} "
          f"reduction={rep.reduction:.1%}"
          + (f" tokens={rep.tokens_generated} ({where})" if args.real_tokens else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
