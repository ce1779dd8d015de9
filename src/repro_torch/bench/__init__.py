"""The port's benchmarks: the twins of the reference's ``benchmarks/``
scripts, run on the card (or with ``--device cpu`` on the CPU).

* :mod:`repro_torch.bench.paper_figs` — the paper's Figs. 3 and 4b-4d
  (``benchmarks/paper_figs.py``);
* :mod:`repro_torch.bench.provision_bench` — the provisioning engine's
  throughput and build gates (``benchmarks/provision_bench.py``);
* :mod:`repro_torch.bench.kernel_bench` — the kernels K1-K4 against their
  plain versions, the long traces of K2, the H100 rooflines and the held
  timer of each kernel (``benchmarks/kernel_bench.py``);
* ``python -m repro_torch.bench`` — the CSV runner (``benchmarks/run.py``);
* :mod:`repro_torch.bench.bench_diff` — the cell-by-cell regression gate of
  two eval reports (``benchmarks/bench_diff.py``), run as
  ``python -m repro_torch.bench.bench_diff BASELINE NEW``.

Each module keeps the reference's function names and row names (but for
the route word, ``provision_bench.ROUTE_WORDS``) and its checks: a failed
check raises and stops the run.
"""
from __future__ import annotations

import importlib
import time

import torch

#: timed calls after the warm one, as in the reference
TIMED_CALLS = 3

# ``repro_torch.core`` re-exports the function ``provision`` over the
# submodule's name, so the module is imported by its full name
_provision = importlib.import_module("repro_torch.core.provision")._provision


def sync(device) -> None:
    """Wait for the card when ``device`` is one (the reference's
    ``block_until_ready``)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def mean_us(fn, iters: int, device) -> float:
    """Mean us of one ``fn()`` call over ``iters`` calls after a warm one,
    each waited for on the card (the reference's ``_bench``)."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        sync(device)
    return (time.perf_counter() - t0) / iters * 1e6


def generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (one per call: a call
    consumes it, and a fresh one repeats the draws)."""
    return torch.Generator(device=device).manual_seed(seed)


def __getattr__(name: str):
    """``BenchDiff`` and ``diff_reports`` of :mod:`.bench_diff`, imported on
    first use (so ``python -m repro_torch.bench.bench_diff`` finds the
    module unimported)."""
    if name in ("BenchDiff", "diff_reports"):
        return getattr(importlib.import_module(f"{__name__}.bench_diff"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
