"""Perf hillclimbing driver: re-trace a cell with config overrides and report
the roofline-term deltas vs the baseline artifact.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch command-r-plus-104b --shape decode_32k \\
        --tag f8cache --set kv_cache_dtype=float8_e4m3fn sp_decode=true

The port of ``repro.launch.hillclimb``: the same flags and overrides, the
dtypes as torch's, and the dry-run's trace (:func:`~repro_torch.launch.
dryrun.run_cell`) in place of a compile.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from .dryrun import run_cell
from .roofline import analyse

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float32": torch.float32,
}


def parse_override(kv: str):
    k, v = kv.split("=", 1)
    if v in _DTYPES:
        return k, _DTYPES[v]
    if v.lower() in ("true", "false"):
        return k, v.lower() == "true"
    try:
        return k, int(v)
    except ValueError:
        pass
    try:
        return k, float(v)
    except ValueError:
        return k, v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--out", default="reports/dryrun")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    overrides = dict(parse_override(kv) for kv in args.set)
    out_dir = Path(args.out)

    mesh = "2x16x16" if args.multi_pod else "16x16"
    base_path = out_dir / f"{args.arch}__{args.shape}__{mesh}.json"
    base = json.loads(base_path.read_text()) if base_path.exists() else None

    rep = run_cell(args.arch, args.shape, args.multi_pod, out_dir,
                   overrides=overrides, tag_suffix=f"__{args.tag}")
    new = analyse(rep, overrides=overrides)

    print(f"== {args.arch} x {args.shape} [{args.tag}] overrides={overrides}")
    if base is not None:
        old = analyse(base)
        for k in ("compute_s", "memory_s", "collective_s"):
            delta = (new[k] - old[k]) / old[k] * 100 if old[k] else float("nan")
            print(f"  {k:>13}: {old[k]:.5f} -> {new[k]:.5f}  ({delta:+.1f}%)")
        print(f"  {'useful frac':>13}: {old['useful_frac']:.3f} -> {new['useful_frac']:.3f}")
        print(f"  {'dominant':>13}: {old['dominant']} -> {new['dominant']}")
    else:
        print(json.dumps({k: new[k] for k in ('compute_s', 'memory_s',
                                              'collective_s', 'dominant')}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
