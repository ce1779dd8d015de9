"""End-to-end serving driver on the PyTorch port: real model, batched
requests, paper autoscaler.

The twin of ``examples/serve_autoscale.py``: a session stream (elephant
jobs, concurrency follows an MSR-like trace) is served by a pool of
replicas running a reduced llama3.2 model.  Sessions are dispatched
last-empty-replica-first; idle replicas run the future-aware ski-rental
(A1) to decide off-vs-idle.  Real tokens are generated on the pinned
replica — no KV cache ever migrates.

On the card the planner's calls are kernel K2 (one launch per sweep or
plan), and the engines run the reduced model's prefill through K3 and its
decode steps through K4, with the reduced model's head dim raised from 16
to 64, the smallest K3 and K4 have an instance for (its width, depth and
vocabulary stay the reduced ones).  On the CPU the reduced model runs as
the reference's does, on the plain route.  A3 draws its waits from a
``torch.Generator`` seeded 0 (the reference: ``jax.random.key(0)``); the
weights come from one seeded 0 on the device.

    PYTHONPATH=src python examples/serve_autoscale_torch.py [--slots 40] [--alpha 0.5] \\
        [--device cuda|cpu]

Without CUDA it exits 2 unless given ``--device cpu``.
"""
import argparse
import sys

import numpy as np

#: the smallest head dim K3 and K4 have an instance for
KERNEL_HEAD_DIM = 64


def slot_concurrency(trace, n_slots: int) -> np.ndarray:
    """Per-slot peak session concurrency — planner input."""
    events = sorted(
        [(s.arrival, 1) for s in trace.sessions]
        + [(s.departure, -1) for s in trace.sessions]
    )
    a = np.zeros(n_slots, np.int64)
    cur, i = 0, 0
    for t in range(n_slots):
        a[t] = cur                      # concurrency carried in from slot start
        while i < len(events) and events[i][0] < t + 1:
            cur += events[i][1]
            a[t] = max(a[t], cur)
            i += 1
    return a


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=40)
    ap.add_argument("--concurrency", type=float, default=2.5)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the planner and the engines run (default: the card)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("serve_autoscale_torch: CUDA is not available; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config
    from repro_torch.core import RANDOMIZED_POLICIES, CostModel, DeferralSpec, PolicySpec
    from repro_torch.data.requests import generate_sessions
    from repro_torch.models import init_params
    from repro_torch.serving import (
        FleetProvisioner,
        InferenceEngine,
        make_window_max_predictor,
        run_cluster,
    )
    from repro_torch.serving.engine import serving_params

    device = args.device
    costs = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)
    trace = generate_sessions(
        np.random.default_rng(0), n_slots=args.slots,
        mean_concurrency=args.concurrency,
    )
    print(f"sessions: {len(trace.sessions)}, horizon {trace.horizon:.0f} slots, "
          f"peak concurrency {trace.to_brick().max_concurrency()}")

    # capacity planning on the batched engine: evaluate every policy's
    # whole alpha-sweep in one call, pick the cheapest window.
    demand = slot_concurrency(trace, args.slots)
    windows = np.arange(int(costs.delta))
    print("\nplanned cost by policy/window (batched engine, one program each):")
    for policy in ("A1", "A3"):
        generator = (torch.Generator(device=device).manual_seed(0)
                     if policy in RANDOMIZED_POLICIES else None)
        planner = FleetProvisioner(
            costs, policy=PolicySpec(policy, generator=generator),
            max_replicas=int(demand.max()) + 1, device=device,
        )
        plan_costs = planner.sweep_costs(demand, windows)
        best = int(np.argmin(plan_costs))
        line = " ".join(f"w={w}:{c:,.0f}" for w, c in zip(windows, plan_costs))
        print(f"  {policy}: {line}  -> best window {windows[best]} "
              f"(alpha={min(1.0, (windows[best] + 1) / costs.delta):.2f})")
    print()

    # deferrable sessions: grant the queue k slots of slack and let the
    # planner water-fill arrivals before provisioning — bursts are absorbed
    # by the backlog instead of replica toggles, and the plan reports the
    # latency actually paid (p99 queueing delay, deadline misses).
    print("planned cost by deferral slack (A1, defer-then-provision):")
    for slack in (0, 1, 2, 4):
        planner = FleetProvisioner(
            costs, policy="A1", max_replicas=int(demand.max()) + 1,
            deferral=DeferralSpec(slack=slack), device=device,
        )
        res = planner.plan(demand)
        x = res.x.cpu().numpy()
        toggles = int(np.maximum(np.diff(x, prepend=0), 0).sum())
        print(f"  slack={slack}: cost={float(res.cost):,.0f} "
              f"toggles(on)={toggles} p99_delay={int(res.p99_delay)} "
              f"misses={int(res.deadline_misses)}")
    print()

    cfg = get_config(args.arch, reduced=True).replace(remat="none")
    if device == "cuda":
        # the float32 unembedding stays out of TF32; K3 and K4 take head dim 64
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = cfg.replace(head_dim=max(cfg.head_dim, KERNEL_HEAD_DIM))
    gen = torch.Generator(device=device).manual_seed(0)
    params = serving_params(init_params(cfg, gen, device=device), cfg, device)

    def factory():
        return InferenceEngine(cfg, params, max_batch=1, max_seq=96, device=device)

    pred = make_window_max_predictor(trace)
    for alpha, use_engines in ((0.0, False), (args.alpha, False), (1.0, False),
                               (args.alpha, True)):
        rep = run_cluster(
            trace, costs, policy="A1", alpha=alpha,
            predictor=pred, engine_factory=factory if use_engines else None,
        )
        if use_engines:       # every session got its tokens from its replica
            want = sum(min(s.max_new_tokens, 16) for s in trace.sessions)
            assert rep.sessions_served == len(trace.sessions) and rep.tokens_generated == want
        tag = " + real generation" if use_engines else ""
        print(
            f"A1(alpha={alpha:.2f}){tag}: cost={rep.total_cost:,.1f} "
            f"static={rep.static_cost:,.0f} reduction={rep.reduction:.1%} "
            f"toggles={rep.scaler.n_turn_on}/{rep.scaler.n_turn_off}"
            + (f" tokens={rep.tokens_generated}" if use_engines else "")
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
