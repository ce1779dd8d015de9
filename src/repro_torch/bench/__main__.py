"""Benchmark harness of the port: the paper's figures, the provisioning
engine and the kernels, as ``name,us_per_call,derived`` CSV lines.

The twin of ``benchmarks/run.py``::

    PYTHONPATH=src python -m repro_torch.bench                  # the card
    PYTHONPATH=src python -m repro_torch.bench --smoke          # CI sizes
    PYTHONPATH=src python -m repro_torch.bench --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.bench --only fig3_competitive_ratios

It prints the rows of :mod:`~repro_torch.bench.paper_figs`,
:mod:`~repro_torch.bench.provision_bench` and
:mod:`~repro_torch.bench.kernel_bench`, in that order, then ``# N benchmark
rows`` on stderr.  The full run has ``kernel_bench``'s production lengths
(T = 10^6 slots, 10^4 lanes); ``--smoke`` runs ``provision_bench``'s CI leg
and ``kernel_bench`` at CI lengths, and all of the figures.  ``--only``
picks benchmark functions by name.  A failed check stops the run with a
traceback and a non-zero exit.  Without CUDA it exits 2 unless given
``--device cpu``; it never falls back to the CPU.  ``--profile DIR`` wraps
the run in ``torch.profiler`` and writes ``DIR/trace.json``.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import torch

from ..obs import profile_to
from . import kernel_bench, paper_figs, provision_bench


def sections(*, smoke: bool, device: str) -> list:
    """``(name, fn(rows))`` of every benchmark function of the run, in the
    order the rows print."""
    return (paper_figs.sections(device=device)
            + provision_bench.sections(device=device, smoke=smoke)
            + kernel_bench.sections(long_full=not smoke, device=device))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="provision_bench's CI leg and kernel_bench's CI lengths")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the benchmarks run (default: the card)")
    ap.add_argument("--only", default=None, metavar="NAME[,NAME...]",
                    help="run only these benchmark functions")
    ap.add_argument("--profile", type=pathlib.Path, default=None, metavar="DIR",
                    help="wrap the run in torch.profiler; write DIR/trace.json")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("repro_torch.bench: CUDA is not available; pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        return 2
    plan = sections(smoke=args.smoke, device=args.device)
    if args.only is not None:
        names = args.only.split(",")
        unknown = sorted(set(names) - {name for name, _ in plan})
        if unknown:
            print(f"repro_torch.bench: no benchmark named {', '.join(unknown)}; the "
                  f"names are {', '.join(name for name, _ in plan)}", file=sys.stderr)
            return 2
        plan = [(name, fn) for name, fn in plan if name in names]
    rows: list[str] = []
    with profile_to(args.profile):
        for _, fn in plan:
            fn(rows)

    print("name,us_per_call,derived")
    for r in rows:
        print(r)
    print(f"# {len(rows)} benchmark rows", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
