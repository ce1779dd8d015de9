"""Serving-cluster simulation: session trace -> autoscaler (+ real engines).

Replays a :class:`SessionTrace` against the paper-driven autoscaler and
reports energy vs the static-provisioning benchmark (paper Sec. V-A).  When
an ``engine_factory`` is supplied, arriving sessions run real prefill+decode
on their pinned replica, demonstrating the end-to-end path.

The port of ``repro.serving.cluster``: numpy over the port's
:class:`ReplicaAutoscaler`, so the schedule is the same on every device;
the engines the factory makes (:class:`repro_torch.serving.InferenceEngine`)
run prefill and decode on theirs, through kernels K3 and K4 on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..core.costs import CostModel
from ..data.requests import SessionTrace
from .autoscaler import ReplicaAutoscaler, ScalerReport


@dataclasses.dataclass
class ClusterReport:
    scaler: ScalerReport
    total_cost: float
    static_cost: float
    reduction: float
    peak_concurrency: int
    sessions_served: int
    tokens_generated: int = 0


def make_window_max_predictor(trace: SessionTrace, noise_std_frac: float = 0.0,
                              rng: np.random.Generator | None = None):
    """Max concurrency over (t0, t1] from the (optionally noised) true trace."""
    brick = trace.to_brick()
    times, vals = brick.a_breakpoints()
    times = np.asarray(times)
    vals = np.asarray(vals, dtype=np.float64)
    rng = rng or np.random.default_rng(0)

    def predictor(t0: float, t1: float) -> float:
        lo = np.searchsorted(times, t0, side="right") - 1
        hi = np.searchsorted(times, t1, side="right")
        window = vals[max(lo, 0):hi]
        if window.size == 0:
            return 0.0
        m = float(window.max())
        if noise_std_frac > 0.0:
            m = max(0.0, m + rng.standard_normal() * noise_std_frac * m)
        return m

    return predictor


def run_cluster(
    trace: SessionTrace,
    costs: CostModel,
    policy: str = "A1",
    alpha: float = 0.0,
    predictor=None,
    engine_factory: Callable[[], object] | None = None,
    rng: np.random.Generator | None = None,
) -> ClusterReport:
    rng = rng or np.random.default_rng(0)
    brick = trace.to_brick()
    peak = brick.max_concurrency()
    n_replicas = peak + 2

    scaler = ReplicaAutoscaler(
        n_replicas, costs, policy=policy, alpha=alpha,
        predictor=predictor, rng=rng, initial_busy=brick.initial_count(),
    )

    # engines are created lazily per replica (weights load == beta_on)
    engines: dict[int, object] = {}
    tokens_generated = 0

    events = []
    for s in trace.sessions:
        events.append((s.arrival, 0, "arrive", s))
        events.append((s.departure, 1, "depart", s))
    events.sort(key=lambda e: (e[0], e[1]))

    session_replica: dict[int, int] = {}
    for t, _, kind, s in events:
        if kind == "arrive":
            rid = scaler.acquire(t)
            session_replica[s.session_id] = rid
            if engine_factory is not None:
                if rid not in engines:
                    engines[rid] = engine_factory()
                eng = engines[rid]
                prompt = np.asarray(
                    rng.integers(0, eng.cfg.vocab_size, (1, min(s.prompt_tokens, 32))),
                    np.int32,
                )
                res = eng.generate(prompt, n_new=min(s.max_new_tokens, 16))
                tokens_generated += res.tokens.size
        else:
            rid = session_replica.pop(s.session_id)
            scaler.release(t, rid)

    report = scaler.finalize(brick.horizon)
    total = report.total_cost(costs)
    static = costs.P * peak * brick.horizon
    return ClusterReport(
        scaler=report,
        total_cost=total,
        static_cost=static,
        reduction=1.0 - total / static,
        peak_concurrency=peak,
        sessions_served=len(trace.sessions),
        tokens_generated=tokens_generated,
    )
