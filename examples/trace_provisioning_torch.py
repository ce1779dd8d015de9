"""Paper experiments on the PyTorch port, interactive: competitive ratios,
PMR sweep, and the fleet-scale declarative provisioner.

The twin of ``examples/trace_provisioning.py``: one ``provision(spec)``
call per policy — batching, α-sweep, prediction-noise sweep, heterogeneous
per-level costs and the level axis sharded over ``torch.distributed`` are
all spec fields.  Traces come from the scenario registry
(``repro_torch.scenarios``); ``python -m repro_torch.eval`` runs the full
competitive-ratio grid.  On the card each online call is one launch of
kernel K2; the sharded part runs the ``mesh=`` route in a world of one
process (``repro_torch.distributed.world.run_world``: NCCL on the card,
gloo on the CPU) and asserts that its schedule is the single-device one.
The randomized policies and the prediction noise draw from
``torch.Generator`` s seeded as the reference seeds its keys, so the drawn
numbers differ from the reference's while the draw-free ones are equal.

    PYTHONPATH=src python examples/trace_provisioning_torch.py [--device cuda|cpu]

Without CUDA it exits 2 unless given ``--device cpu``.
"""
import argparse
import dataclasses
import pathlib
import sys

import numpy as np

STDS = (0.0, 0.25, 0.5)          # the flash-crowd noise sweep
SWEPT_STDS = (0.0, 0.25)         # the sharded (noise std x window) grid
SWEPT_WINDOWS = (0, 1, 2)


def _generator(device, seed):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


def fleet_spec(demand, n_levels, device):
    """A1 at window 2 over one week of demand: the fleet-scale spec."""
    from repro_torch.core import PAPER_COSTS, PolicySpec, ProvisionSpec, Workload

    return ProvisionSpec(costs=PAPER_COSTS, workload=Workload(demand=demand),
                         policy=PolicySpec("A1", window=2), n_levels=n_levels,
                         device=device)


def swept_spec(spec, device):
    """The (noise std x window) sweep of ``spec`` in one call."""
    from repro_torch.core import PolicySpec, PredictionNoise, Workload

    return dataclasses.replace(
        spec,
        workload=Workload(demand=spec.workload.demand, noise=PredictionNoise(
            std_frac=list(SWEPT_STDS), generator=_generator(device, 2))),
        policy=PolicySpec("A1", windows=list(SWEPT_WINDOWS)),
    )


def sharded_rank(mesh, payload):
    """One rank of the sharded part: the fleet spec, A3 on it and the swept
    grid, each with its level axis on ``mesh``, and the rank's K2 launches
    (one per call on the card)."""
    from repro_torch.core import PolicySpec, provision
    from repro_torch.kernels import provision_scan

    before = provision_scan.stream_launches
    device = payload["device"]
    spec = dataclasses.replace(fleet_spec(payload["demand"], payload["n_levels"], device),
                               mesh=mesh)
    a3 = dataclasses.replace(spec, policy=PolicySpec("A3", window=2,
                                                     generator=_generator(device, 1)))
    swept = provision(swept_spec(spec, device))
    out = {"x": provision(spec).x.cpu(), "x_a3": provision(a3).x.cpu(),
           "swept_x": swept.x.cpu(), "swept_cost": swept.cost.cpu()}
    out["launches"] = provision_scan.stream_launches - before
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where provision() runs (default: the card)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("trace_provisioning_torch: CUDA is not available; pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        return 2

    from repro_torch.core import (
        PAPER_COSTS,
        CostModel,
        PolicySpec,
        ProvisionSpec,
        Workload,
        fluid_cost,
        provision,
        theoretical_ratio,
    )
    from repro_torch.core.traces import WEEK_SLOTS
    from repro_torch.distributed.world import run_world
    from repro_torch.scenarios import Scenario, generate, make_workload

    device = args.device
    costs = PAPER_COSTS                       # P = 1, beta 3/3 => Delta = 6
    delta = int(costs.delta)
    msr = Scenario("msr_diurnal", target_pmr=4.63, mean_jobs=40.0)
    trace = generate(msr, 1, WEEK_SLOTS)[0]
    n_levels = int(trace.max()) + 1
    windows = list(range(delta))

    def run(demand, policy, n=n_levels, model=costs):
        return provision(ProvisionSpec(costs=model, workload=Workload(demand=demand),
                                       policy=policy, n_levels=n, device=device))

    # --- Fig. 3: worst-case vs empirical ratios over alpha — the whole
    # (runs x alpha) grid per policy is one provision() call (one K2 launch).
    print("Fig.3 — competitive ratios (Delta = 6, declarative engine):")
    print(f"{'alpha':>6} {'A1 bound':>9} {'A1 emp':>8} {'A3 bound':>9} {'A3 emp':>8}")
    opt = fluid_cost(trace, "offline", costs).cost
    a1 = run(trace, PolicySpec("A1", windows=windows)).cost.cpu().numpy() / opt
    runs = 20
    batch = np.tile(trace, (runs, 1))
    a3 = run(batch, PolicySpec("A3", windows=windows, generator=_generator(device, 0))
             ).cost.cpu().numpy().mean(axis=1) / opt
    for i, w in enumerate(windows):
        alpha = min(1.0, (w + 1) / costs.delta)
        print(f"{alpha:>6.2f} {theoretical_ratio('A1', alpha):>9.3f} {a1[i]:>8.3f} "
              f"{theoretical_ratio('A3', alpha):>9.3f} {a3[i]:>8.3f}")

    # --- Fig. 4d: PMR sweep — the scenario's target_pmr knob (same seed =>
    # same base shape, only the Section V-D rescale differs)
    print("\nFig.4d — savings vs peak-to-mean ratio (offline optimum):")
    for target in (2, 4, 6, 8, 10):
        a = generate(dataclasses.replace(msr, target_pmr=float(target)), 1, WEEK_SLOTS)[0]
        st = fluid_cost(a, "static", costs).cost
        op = fluid_cost(a, "offline", costs).cost
        print(f"  PMR={target:>2}: reduction {1 - op / st:6.1%}")

    # --- scenario bank + noise sweep: one Workload from the registry, the
    # prediction-error study as a (S,) sweep axis (common random numbers)
    print("\nFlash crowd under prediction error (PredictionNoise sweep axis):")
    wl = make_workload(
        Scenario("flash_crowd", target_pmr=4.63, mean_jobs=40.0),
        n_traces=8, n_slots=WEEK_SLOTS, noise_std=list(STDS),
        noise_generator=_generator(device, 0),
    )
    peak = int(wl.demand.max()) + 1
    res = provision(ProvisionSpec(costs=costs, workload=wl, policy=PolicySpec("A1", window=2),
                                  n_levels=peak, device=device))
    opt_b = run(wl.demand, PolicySpec("offline"), n=peak)
    cr = (res.cost / opt_b.cost[None, :]).cpu().numpy()
    alpha = (2 + 1) / costs.delta
    for s, std in enumerate(STDS):
        print(f"  std={std:4}: mean CR {cr[s].mean():.3f} "
              f"(A1 bound {theoretical_ratio('A1', alpha):.2f})")

    # --- heterogeneous fleet: the bottom of the LIFO stack is cheap-to-idle
    # baseload (big Delta), the top is bursty spot capacity (small Delta) —
    # one (n_levels,) CostModel, same single call.
    print("\nHeterogeneous fleet (per-level Delta, one provision(spec) call):")
    n_base = int(n_levels * 0.5)
    beta = np.where(np.arange(n_levels) < n_base, 4.5, 1.5)   # Delta 9 / 3
    res = run(trace, PolicySpec("A1", window=2), n=None,
              model=CostModel(P=1.0, beta_on=beta, beta_off=beta))
    lc = res.level_cost.cpu().numpy()
    print(f"  total={float(res.cost):,.0f}  energy={float(res.energy):,.0f} "
          f"toggles={float(res.toggle_cost):,.0f}")
    print(f"  baseload levels (Delta=9): {lc[:n_base].sum():,.0f}; "
          f"spot levels (Delta=3): {lc[n_base:].sum():,.0f}")

    # --- fleet-scale: the same spec, levels sharded over a mesh of one
    # process (the mesh= route: K2 on each rank's block of levels)
    print("\nfleet provisioner (the mesh= route over torch.distributed, kernel K2):")
    spec = fleet_spec(trace, n_levels, device)
    res = provision(spec)
    print(f"  A1 x(t): max={int(res.x.max())}, mean={float(res.x.float().mean()):.1f} "
          f"(demand mean {trace.mean():.1f})")
    here = str(pathlib.Path(__file__).resolve().parent)
    if here not in sys.path:            # the rank imports this file by its name
        sys.path.insert(0, here)
    sharded = run_world(f"{pathlib.Path(__file__).stem}:sharded_rank", 1, device=device,
                        payload={"demand": trace, "n_levels": n_levels, "device": device})[0]
    assert torch.equal(res.x.cpu(), sharded["x"])
    assert sharded["launches"] == (3 if device == "cuda" else 0)
    print("  sharded over 1 device(s): identical schedule ✓")
    print(f"  A3 (randomized, sharded): max={int(sharded['x_a3'].max())}, "
          f"mean={float(sharded['x_a3'].float().mean()):.1f}")

    # --- the whole (noise-std x window) sweep rides the same fleet path,
    # bit-exact against the unsharded engine on the same draws
    plain = provision(swept_spec(spec, device))
    assert torch.equal(plain.x.cpu(), sharded["swept_x"])
    print("  (S=2 stds x W=3 windows) through the mesh route, "
          "cost table (rows=std, cols=window):")
    print("  " + str(sharded["swept_cost"].numpy().round(0)).replace("\n", "\n  "))
    return 0


if __name__ == "__main__":
    sys.exit(main())
