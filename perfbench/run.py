"""Run one cell of ``BENCHMARK.json`` once, on the card this process finds.

    python3 perfbench/run.py --workload yi-9b.longdoc --seed 7 --seconds 40 --trace 0

From the root of a checkout.  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number compared beside its limit; those numbers are also
the last lines of standard error.  It exits 2, printing no result, where
CUDA is absent or the card count is short of the cell's, where the
manifest or a file it names is missing, and where a module of JAX or of
the JAX package ``repro`` is loaded once the window has closed.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")

    # every build and kernel cache inside the checkout, at fixed paths; the
    # port builds its kernels into build/repro_torch_kernels of the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    from perfbench import harness, manifest

    try:
        cell = manifest.load_cell(args.workload)
    except (FileNotFoundError, KeyError, ValueError) as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    found = harness.loaded_forbidden()
    if found:
        print(f"perfbench: modules of {found} were loaded in this process; the benchmark "
              "runs the port alone", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
