"""Training launcher: ``--arch <id>`` selects an architecture the port has.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --full --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --device cpu

The port of ``repro.launch.train``, with its flags plus ``--device`` and
``--full``.  It trains the arch's reduced config (``remat="none"``, as the
reference's launcher does) with the full fault-tolerant loop — checkpoints,
auto-resume, optional int8 gradient compression — on the card, unless
``--device cpu`` is given; without CUDA and without that flag it exits 2.
``--full`` trains the published config instead (``remat="full"``), the one
way to reach full width through the entry point.  ``--dry-run`` traces the
FULL config's train step (``--shape``, default ``train_4k``) on the
production mesh instead, with nothing allocated
(:func:`repro_torch.launch.dryrun.run_cell`: a ``"fake"`` group of 256
ranks, or 512 with ``--multi-pod``, in this process, on the CPU), and
prints the reference's ``compiled <arch> x <shape>: flops/dev=...`` line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --dry-run
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="train the published config, not the reduced one")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train (default: the card)")
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
        print("repro_torch.launch.train: CUDA is not available; pass --device cpu to "
              "train on the CPU", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config
    from repro_torch.train.trainer import Trainer, TrainerConfig

    # the unembedding's float32 products stay out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch, reduced=not args.full)
    cfg = cfg.replace(remat="full" if args.full else "none")
    tcfg = TrainerConfig(
        total_steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, grad_compression=args.compress_grads, device=args.device,
    )
    out = Trainer(cfg, tcfg).run()
    if out["history"]:
        print(f"final loss: {out['history'][-1][1]:.4f} "
              f"@ step {out['final_step']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
