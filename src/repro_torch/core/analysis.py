"""Competitive-ratio and cost-saving analysis helpers (paper Section V).

A copy of ``repro.core.analysis`` (numpy and the stdlib only).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import fluid
from .costs import CostModel
from .events import BrickTrace
from .offline import a0_cost
from .online import simulate
from .ski_rental import (
    A1Deterministic,
    A2Randomized,
    A3Randomized,
    theoretical_ratio,
)

POLICY_CLASSES = {
    "A1": A1Deterministic,
    "A2": A2Randomized,
    "A3": A3Randomized,
}


@dataclasses.dataclass
class RatioReport:
    policy: str
    alpha: float
    empirical: float
    theoretical: float


def empirical_ratio_brick(
    trace: BrickTrace,
    policy_name: str,
    alpha: float,
    costs: CostModel,
    n_runs: int = 1,
    seed: int = 0,
) -> RatioReport:
    """Empirical competitive ratio of a policy on one brick trace."""
    opt = a0_cost(trace, costs)
    tot = 0.0
    for r in range(n_runs):
        rng = np.random.default_rng(seed + r)
        pol = POLICY_CLASSES[policy_name](alpha=alpha)
        tot += simulate(trace, pol, costs, rng=rng).cost
    emp = (tot / n_runs) / opt
    return RatioReport(policy_name, alpha, emp, theoretical_ratio(policy_name, alpha))


def empirical_ratio_fluid(
    a: np.ndarray,
    policy_name: str,
    window: int,
    costs: CostModel,
    n_runs: int = 1,
    seed: int = 0,
) -> RatioReport:
    opt = fluid.fluid_cost(a, "offline", costs).cost
    tot = 0.0
    for r in range(n_runs):
        rng = np.random.default_rng(seed + r)
        tot += fluid.fluid_cost(a, policy_name, costs, window=window, rng=rng).cost
    alpha = min(1.0, (window + 1) / costs.delta)
    return RatioReport(policy_name, alpha, (tot / n_runs) / opt,
                       theoretical_ratio(policy_name, alpha))


def cost_reduction_table(
    a: np.ndarray,
    costs: CostModel,
    windows: list[int],
    n_runs: int = 5,
    seed: int = 0,
) -> dict[str, list[float]]:
    """Paper Fig. 4b: cost reduction vs static provisioning per window size."""
    static = fluid.fluid_cost(a, "static", costs).cost
    out: dict[str, list[float]] = {"window": [float(w) for w in windows]}
    out["offline"] = [1.0 - fluid.fluid_cost(a, "offline", costs).cost / static] * len(windows)
    for name in ("A1", "A2", "A3"):
        vals = []
        for w in windows:
            tot = 0.0
            for r in range(n_runs):
                rng = np.random.default_rng(seed + r)
                tot += fluid.fluid_cost(a, name, costs, window=w, rng=rng).cost
            vals.append(1.0 - (tot / n_runs) / static)
        out[name] = vals
    out["delayedoff"] = [
        1.0 - fluid.fluid_cost(a, "delayedoff", costs).cost / static
    ] * len(windows)
    out["lcp"] = [
        (1.0 - fluid.fluid_cost(a, "lcp", costs, window=w).cost / static)
        if w >= 1
        else float("nan")
        for w in windows
    ]
    return out
