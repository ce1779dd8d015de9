"""Brute-force dynamic-programming oracle for SCP (validation only).

Solves the discrete-slot problem exactly:

    min  sum_t P * x_t  +  sum_t beta_on*[x_t - x_{t-1}]+ + beta_off*[...]-
    s.t. x_t >= a_t,  x_0 = a_0,  x_{T-1} = a_{T-1},  x_t integer

by DP over (slot, level).  O(T * X^2) with X = max(a) + slack; used in tests
to certify the critical-segment construction and the per-level decomposition.

A copy of ``repro.core.dp_oracle`` (numpy only).
"""
from __future__ import annotations

import numpy as np

from .costs import CostModel


def dp_optimal_cost(a: np.ndarray, costs: CostModel, slack: int | None = None) -> float:
    a = np.asarray(a, dtype=np.int64)
    T = len(a)
    if T == 0:
        return 0.0
    x_max = int(a.max()) + (slack if slack is not None else int(a.max()) + 1)
    levels = np.arange(x_max + 1, dtype=np.float64)

    INF = np.inf
    # dp[x] = min cost of slots 0..t with x_t = x
    dp = np.full(x_max + 1, INF)
    dp[int(a[0])] = costs.P * a[0]
    for t in range(1, T):
        # transition cost from y (prev) to x: beta_on*(x-y)+ + beta_off*(y-x)+
        diff = levels[None, :] - levels[:, None]       # [prev y, next x]
        trans = np.where(diff > 0, costs.beta_on * diff, -costs.beta_off * diff)
        cand = dp[:, None] + trans                     # [y, x]
        ndp = cand.min(axis=0) + costs.P * levels
        ndp[: int(a[t])] = INF                         # x_t >= a_t
        if t == T - 1:
            keep = np.full_like(ndp, INF)
            keep[int(a[t])] = ndp[int(a[t])]           # x_{T-1} = a_{T-1}
            ndp = keep
        dp = ndp
    return float(dp.min())
