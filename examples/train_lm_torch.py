"""Train a small LM end-to-end with the PyTorch port's fault-tolerant
trainer.

The twin of ``examples/train_lm.py``: deterministic data, atomic
checkpoints, auto-resume, optional int8 gradient compression, on
``--device``.  With --steps 300 this trains a ~5M-param llama-family model
(the arch's reduced config) to visibly decreasing loss.  The train step
differentiates the plain route (the attention kernels have no backward
pass), so training launches no kernel.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 [--arch yi-9b] [--device cuda|cpu]
    # kill it mid-run and re-run: it resumes from the last checkpoint.

The checkpoints go to ``--ckpt-dir`` (default: ``repro_torch_train_lm`` in
the temporary directory).  Without CUDA it exits 2 unless given
``--device cpu``.
"""
import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train (default: the card)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("train_lm_torch: CUDA is not available; pass --device cpu to train on "
              "the CPU", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config
    from repro_torch.train.trainer import Trainer, TrainerConfig

    # the unembedding's float32 products stay out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch, reduced=True).replace(remat="none")
    tcfg = TrainerConfig(
        total_steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        log_every=10,
        grad_compression=args.compress_grads,
        device=args.device,
    )
    out = Trainer(cfg, tcfg).run()
    first = out["history"][0][1] if out["history"] else float("nan")
    last = out["history"][-1][1] if out["history"] else float("nan")
    print(f"\ntrained {args.arch} (reduced) to step {out['final_step']}: "
          f"loss {first:.3f} -> {last:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
