"""Discrete-time fluid workload engine (paper Sections IV-C, V).

Level decomposition: with the paper's slot-wise LIFO rule
and a fixed push order, server ``l`` (0-indexed) is busy in slot ``t`` iff
``a[t] > l``.  Provisioning therefore decomposes into independent per-level
ski-rental instances on the indicator traces, and every algorithm below is a
per-level gap computation.  Tests verify the decomposition against a
brute-force DP oracle and the critical-segment construction.

Two engines:
  * closed-form per-gap costs (exact predictions) — fast path;
  * slot-scan engine supporting erroneous predicted traces (Section V-C).

All times are in slot units; ``CostModel.P`` is energy per slot per server.

A copy of ``repro.core.fluid`` (numpy and the stdlib only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from .costs import CostModel

E = math.e


@dataclasses.dataclass
class FluidResult:  # repro-lint: disable=RPL005
    cost: float
    energy: float
    toggle_cost: float
    x: np.ndarray | None = None   # per-slot number of running servers


# ---------------------------------------------------------------------------
# Gap extraction
# ---------------------------------------------------------------------------

def level_gaps(a: np.ndarray, level: int) -> tuple[int, list[tuple[int, int]], int, int, int]:
    """Busy/gap structure of one level.

    Returns (busy_slots, interior_gaps[(start, length)], lead_len, trail_len,
    first_busy) where interior gaps lie strictly between busy runs.
    """
    busy = np.asarray(a) > level
    idx = np.flatnonzero(busy)
    if idx.size == 0:
        return 0, [], len(a), 0, -1
    gaps = []
    d = np.diff(idx)
    for k in np.flatnonzero(d > 1):
        gaps.append((int(idx[k]) + 1, int(d[k]) - 1))
    lead = int(idx[0])
    trail = int(len(a) - 1 - idx[-1])
    return int(idx.size), gaps, lead, trail, int(idx[0])


# ---------------------------------------------------------------------------
# Closed-form per-gap policy costs (exact predictions)
# ---------------------------------------------------------------------------

def _gap_cost_offline(g: float, b: float, P: float, beta: float) -> float:
    return min(g * P, beta)


def _make_gap_cost_a1(w: int, b: int) -> Callable[[float], tuple[float, float]]:
    """Returns fn(g) -> (interior cost, trailing idle slots before forced off).

    A1 waits m = max(0, b - w - 1) slots, then peeks the visible window
    (slots t+1 .. t+w, i.e. pops up to real time t + w + 1)."""

    def fn(g):
        m = max(0, b - w - 1)
        if g <= m + w + 1:   # pop happens during wait or is visible in window
            return g, None   # idle throughout (cost g*P), no toggle
        return m, "off"

    return fn


def sample_wait_a2(alpha: float, b: float, rng: np.random.Generator) -> float:
    span = (1.0 - alpha) * b
    if span <= 0:
        return 0.0
    return span * math.log1p(rng.uniform() * (E - 1.0))


def sample_wait_a3(alpha: float, b: float, rng: np.random.Generator) -> float:
    if rng.uniform() < alpha / (E - 1.0 + alpha):
        return 0.0
    return sample_wait_a2(alpha, b, rng)


def fluid_cost(
    a: np.ndarray,
    policy: str,
    costs: CostModel,
    window: int = 0,
    rng: np.random.Generator | None = None,
    t_wait_factor: float = 1.0,
) -> FluidResult:
    """Closed-form fluid cost for policy in
    {offline, A1, A2, A3, delayedoff, lcp, static}.

    ``window`` = number of *future* slots known (the current slot is always
    known — it drives the dispatcher).  Effective alpha = min(1, (window+1)/b)
    as derived in the paper's Section V-B discussion (window = Delta - 1
    already achieves the optimum).
    """
    rng = rng or np.random.default_rng(0)
    a = np.asarray(a, dtype=np.int64)
    P, beta = costs.P, costs.beta
    b = costs.delta  # in slots
    bi = int(round(b))
    w = int(window)
    alpha = min(1.0, (w + 1) / b)

    if policy == "static":
        peak = int(a.max())
        energy = P * peak * len(a)
        return FluidResult(cost=energy, energy=energy, toggle_cost=0.0)

    if policy == "lcp" and w < 1:
        raise ValueError("LCP(w) needs at least one future slot (paper Sec. V-B)")

    n_levels = int(a.max())
    energy = 0.0
    toggle = 0.0
    for level in range(n_levels):
        busy, gaps, lead, trail, first = level_gaps(a, level)
        if busy == 0:
            continue
        energy += P * busy
        # beta_on at first use if the level starts off (x(0) = a(0)).
        if level >= a[0]:
            toggle += costs.beta_on
        for _, g in gaps:
            e_idle, t_tog = _interior_gap(policy, g, b, bi, w, alpha, P, beta, rng,
                                          t_wait_factor)
            energy += e_idle
            toggle += t_tog
        # trailing gap: forced off by x(T) = a(T); offline turns off instantly.
        if trail > 0:
            e_idle, _ = _trailing_gap(policy, trail, b, bi, w, alpha, P, rng,
                                      t_wait_factor)
            energy += e_idle
            toggle += costs.beta_off
    return FluidResult(cost=energy + toggle, energy=energy, toggle_cost=toggle)


def _interior_gap(policy, g, b, bi, w, alpha, P, beta, rng, t_wait_factor):
    """(idle energy, toggle cost) for one interior gap of length g slots."""
    if policy == "offline":
        return (g * P, 0.0) if g * P <= beta else (0.0, beta)
    if policy == "A1":
        m = max(0.0, b - w - 1)
        # peek covers (m, m + alpha*b]; info beyond the critical window is
        # useless and A1 does not use it (paper Theorem 7 remark (i)).
        if g <= m + min(w + 1, b):
            return g * P, 0.0
        return m * P, beta
    if policy in ("A2", "A3"):
        z = sample_wait_a2(alpha, b, rng) if policy == "A2" else sample_wait_a3(alpha, b, rng)
        if g <= z:
            return g * P, 0.0
        # peek at decision time z with visibility through z + alpha*b
        if g <= z + alpha * b:
            return g * P, 0.0
        return z * P, beta
    if policy == "delayedoff":
        tw = t_wait_factor * b
        if g <= tw:
            return g * P, 0.0
        return tw * P, beta
    if policy == "lcp":
        # LCP's window must cover the *current* slot (x_t is set before slot t
        # is observed, Lin et al.), and its lazy upper envelope keeps a server
        # on through ties, so it turns off one slot later than the hindsight
        # threshold: m = b - w + 1.  Net effect: LCP(w) ~ A1 with
        # alpha = (w-1)/b, matching the paper's Fig. 4b placement.
        m = max(0.0, b - w + 1)
        if g <= b:
            return g * P, 0.0
        return m * P, beta
    raise KeyError(policy)


def _trailing_gap(policy, trail, b, bi, w, alpha, P, rng, t_wait_factor):
    """Idle energy before the forced turn-off at the horizon."""
    if trail <= 0 or policy == "offline":
        return 0.0, None
    if policy == "A1":
        m = max(0.0, b - w - 1)
        return min(trail, m) * P, None
    if policy in ("A2", "A3"):
        z = sample_wait_a2(alpha, b, rng) if policy == "A2" else sample_wait_a3(alpha, b, rng)
        return min(trail, z) * P, None
    if policy == "delayedoff":
        return min(trail, t_wait_factor * b) * P, None
    if policy == "lcp":
        return min(trail, max(0.0, b - w + 1)) * P, None
    raise KeyError(policy)


# ---------------------------------------------------------------------------
# Slot-scan engine (supports erroneous predictions; returns x per slot)
# ---------------------------------------------------------------------------

def fluid_scan(
    a: np.ndarray,
    policy: str,
    costs: CostModel,
    window: int = 0,
    predicted: np.ndarray | None = None,
    rng: np.random.Generator | None = None,
) -> FluidResult:
    """Slot-by-slot simulation.  ``predicted`` is the trace the peek step
    reads (defaults to ``a``); the dispatcher always sees the true current
    load.  Decisions happen at slot granularity.
    """
    rng = rng or np.random.default_rng(0)
    a = np.asarray(a, dtype=np.int64)
    pred = a if predicted is None else np.asarray(predicted, dtype=np.int64)
    P, beta = costs.P, costs.beta
    b = costs.delta
    w = int(window)
    alpha = min(1.0, (w + 1) / b)
    T = len(a)
    n_levels = int(max(a.max(), 1))

    # per-level state
    on = a[0] > np.arange(n_levels)          # x(0) = a(0)
    idle_run = np.zeros(n_levels)            # consecutive idle slots while on
    wait_target = np.full(n_levels, np.inf)  # sampled wait for randomized pols

    energy = 0.0
    toggle = 0.0
    x_hist = np.zeros(T, dtype=np.int64)

    for t in range(T):
        busy = a[t] > np.arange(n_levels)
        # dispatcher: busy levels must be on (turn on if off)
        turn_on = busy & ~on
        toggle += costs.beta_on * int(turn_on.sum())
        on = on | busy
        idle_run = np.where(busy, 0.0, idle_run)
        # idle levels that are on: advance idle time, decide
        idle = on & ~busy
        new_idle = idle & (idle_run == 0.0)
        if policy in ("A2", "A3"):
            for lv in np.flatnonzero(new_idle):
                wait_target[lv] = (
                    sample_wait_a2(alpha, b, rng)
                    if policy == "A2"
                    else sample_wait_a3(alpha, b, rng)
                )
        idle_run = np.where(idle, idle_run + 1.0, idle_run)

        # decision: turn off this slot? (before paying the slot's idle energy)
        off_now = np.zeros(n_levels, dtype=bool)
        for lv in np.flatnonzero(idle):
            r = idle_run[lv] - 1.0   # idle slots fully elapsed before slot t
            if policy == "offline":
                # hindsight: look at the true future
                fut = np.flatnonzero(a[t:] > lv)
                gap_total = r + (fut[0] if fut.size else np.inf)
                off_now[lv] = gap_total * P > beta or not fut.size
            elif policy in ("A1", "A2", "A3"):
                m = max(0.0, b - w - 1) if policy == "A1" else wait_target[lv]
                if r >= m:
                    # Window covers pops through real time t + min(w+1, b):
                    # the current slot is observed and the right edge of the
                    # continuous window [tau, tau + alpha*Delta] includes an
                    # arrival at the boundary instant; capped at alpha*Delta.
                    horizon_slots = int(min(w + 1, math.ceil(b)))
                    seen_future = pred[t + 1 : t + horizon_slots + 1] > lv
                    off_now[lv] = not seen_future.any()
            elif policy == "delayedoff":
                off_now[lv] = r >= b
            elif policy == "lcp":
                # knowledge = slots t .. t+w-1 (window includes current slot)
                seen_future = pred[t + 1 : t + w] > lv
                if seen_future.any():
                    nxt = t + 1 + int(np.flatnonzero(seen_future)[0])
                    gap_if_wait = r + (nxt - t)
                    off_now[lv] = gap_if_wait * P > beta
                else:
                    off_now[lv] = r >= max(0.0, b - w + 1)
            else:
                raise KeyError(policy)
        toggle += costs.beta_off * int(off_now.sum())
        on = on & ~off_now
        idle_run = np.where(off_now, 0.0, idle_run)
        energy += P * int(on.sum())
        x_hist[t] = int(on.sum())

    # horizon: force x(T) = a(T): all still-idle levels off
    still_idle = on & ~(a[-1] > np.arange(n_levels))
    toggle += costs.beta_off * int(still_idle.sum())
    return FluidResult(cost=energy + toggle, energy=energy, toggle_cost=toggle, x=x_hist)


def cost_reduction_vs_static(cost: float, a: np.ndarray, costs: CostModel) -> float:
    static = fluid_cost(a, "static", costs).cost
    return 1.0 - cost / static
