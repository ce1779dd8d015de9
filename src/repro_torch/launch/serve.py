"""Serving launcher: session stream -> paper autoscaler (+ real generation).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --policy A1 --alpha 0.5 [--real-tokens] [--device cuda|cpu]

The port of ``repro.launch.serve``, with the reference's flags plus
``--device``.  On the card (the default) ``--real-tokens`` gives every
replica an :class:`~repro_torch.serving.InferenceEngine` of the arch (any
of the ten the port registers) at its full width, with random weights
from seed 0 shared by all replicas, running kernels K3 and K4 (xLSTM runs
neither; paligemma-3b's 256 image tokens overflow the 96-slot engines,
as in the reference, ROADMAP.md § 3.10); ``--device cpu`` runs the arch's
reduced config on the plain route, as the reference's launcher does.  Without CUDA and
without ``--device cpu`` it exits 2.  ``--dry-run`` and ``--multi-pod``
need the dry-run launcher, not ported yet (ROADMAP.md, Queue 1 item F):
they exit 2 and say so.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


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

    if args.dry_run or args.multi_pod:
        print("repro_torch.launch.serve: --dry-run and --multi-pod need the dry-run "
              "launcher (launch/dryrun.py), which is not ported yet", file=sys.stderr)
        return 2

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("repro_torch.launch.serve: CUDA is not available; pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config
    from repro_torch.core import CostModel
    from repro_torch.data.requests import generate_sessions
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine, make_window_max_predictor, run_cluster
    from repro_torch.serving.engine import serving_params

    costs = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)
    trace = generate_sessions(np.random.default_rng(0), n_slots=args.slots,
                              mean_concurrency=args.concurrency)
    factory = None
    if args.real_tokens:
        # the model's float32 products (the unembedding) stay out of TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = get_config(args.arch, reduced=args.device == "cpu").replace(remat="none")
        gen = torch.Generator(device=args.device).manual_seed(0)
        params = serving_params(init_params(cfg, gen, device=args.device), cfg, args.device)

        def factory():
            return InferenceEngine(cfg, params, max_batch=1, max_seq=96, device=args.device)

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
