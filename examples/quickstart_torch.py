"""Quickstart on the PyTorch port: the paper's dynamic-provisioning
algorithms in 60 seconds.

The twin of ``examples/quickstart.py``: the offline optimum and the three
future-aware online algorithms (A1/A2/A3) plus LCP(w) and DELAYEDOFF on a
synthetic MSR-like one-week trace (PMR ~ 4.63, 10-minute slots, Delta = 6
slots — the paper's Section V setup), with cost reductions vs static peak
provisioning, printed line for line as the reference prints them.

The offline optimum, A1 at every window (one sweep) and DELAYEDOFF run
through ``repro_torch.provision`` on ``--device`` — on the card each online
call is one launch of kernel K2, the offline optimum a closed form.  A2 and
A3 (20 runs each, drawn from numpy generators seeded 0..19 as the
reference draws them) and LCP(w) run in the port's fluid model, the numpy
copy of the reference's.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

Without CUDA it exits 2 unless given ``--device cpu``.
"""
import argparse
import sys

import numpy as np

WINDOWS = (0, 2, 4, 5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where provision() runs (default: the card)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("quickstart_torch: CUDA is not available; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 2

    from repro_torch.core import (
        CostModel,
        PolicySpec,
        ProvisionSpec,
        Workload,
        fluid_cost,
        msr_like_trace,
        pmr,
        provision,
        theoretical_ratio,
    )

    costs = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)   # Delta = 6 slots

    def on_device(policy, **pol):
        return provision(ProvisionSpec(
            costs=costs, workload=Workload(demand=trace),
            policy=PolicySpec(policy, **pol), device=args.device,
        )).cost.cpu().numpy()

    trace = msr_like_trace(np.random.default_rng(0))
    print(f"trace: {len(trace)} slots, peak={trace.max()}, "
          f"mean={trace.mean():.1f}, PMR={pmr(trace):.2f}")

    static = fluid_cost(trace, "static", costs).cost
    opt = float(on_device("offline"))
    a1 = dict(zip(WINDOWS, on_device("A1", windows=list(WINDOWS)).tolist()))
    print(f"\nstatic provisioning cost : {static:,.0f}")
    print(f"offline optimal cost     : {opt:,.0f}  "
          f"({1 - opt / static:.1%} reduction)\n")

    print(f"{'policy':<12}{'window':>7}{'cost':>12}{'reduction':>11}"
          f"{'emp.ratio':>11}{'bound':>8}")
    for window in WINDOWS:
        alpha = min(1.0, (window + 1) / costs.delta)
        for name in ("A1", "A2", "A3"):
            if name == "A1":
                cost = a1[window]
            else:
                cost = np.mean([
                    fluid_cost(trace, name, costs, window=window,
                               rng=np.random.default_rng(r)).cost
                    for r in range(20)
                ])
            print(f"{name:<12}{window:>7}{cost:>12,.0f}"
                  f"{1 - cost / static:>10.1%}{cost / opt:>11.3f}"
                  f"{theoretical_ratio(name, alpha):>8.3f}")
        if window >= 1:
            c = fluid_cost(trace, "lcp", costs, window=window).cost
            print(f"{'LCP(w)':<12}{window:>7}{c:>12,.0f}"
                  f"{1 - c / static:>10.1%}{c / opt:>11.3f}{'--':>8}")
    c = float(on_device("delayedoff"))
    print(f"{'DELAYEDOFF':<12}{'--':>7}{c:>12,.0f}"
          f"{1 - c / static:>10.1%}{c / opt:>11.3f}{'2.000':>8}")
    print("\nNote: A1/A2/A3 reach the offline optimum at window = Delta-1 = 5 "
          "(paper Fig. 4b).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
