"""Offline optimum for problem SCP (paper Section III).

Two independent implementations, cross-checked in tests:

1. :func:`optimal_schedule_constructed` — the literal *Optimal Solution
   Construction Procedure*: visit critical segments, apply the Type I-IV
   rules (with the greedy (tau_l, tau_l') pairing inside Type-IV segments).

2. :func:`a0_schedule` / :func:`a0_cost` — the decentralized offline
   algorithm A0 (Section III-D): last-empty-server-first dispatch + each
   server solving its ski-rental instance with hindsight.  Its schedule is
   ``x(t) = a(t) + #idle servers``, where a server whose LIFO empty period
   has length g stays idle iff g <= Delta.  Theorem 5: both coincide.

A copy of ``repro.core.offline`` (the stdlib only).
"""
from __future__ import annotations

from .costs import CostModel, schedule_cost
from .events import BrickTrace
from .segments import SegmentType, critical_segments
from .stepfn import StepFn, from_breakpoints


# ---------------------------------------------------------------------------
# A0: decentralized offline optimum from the LIFO matching
# ---------------------------------------------------------------------------

def a0_schedule(trace: BrickTrace, costs: CostModel) -> StepFn:
    """x(t) produced by algorithm A0 (optimal, Theorem 5)."""
    delta = costs.delta
    times, vals = trace.a_breakpoints()
    # Idle-server increments: for each matched empty period [dep, arr] with
    # arr - dep <= Delta the server stays idle, adding +1 to x on [dep, arr).
    deltas: dict[float, int] = {}
    for dep, arr in trace.empty_periods():
        if arr is not None and (arr - dep) <= delta:
            deltas[dep] = deltas.get(dep, 0) + 1
            deltas[arr] = deltas.get(arr, 0) - 1
    all_times = sorted(set(times) | set(deltas))
    x_vals = []
    idle = 0
    ai = 0
    cur_a = vals[0]
    for t in all_times:
        while ai + 1 < len(times) and times[ai + 1] <= t:
            ai += 1
            cur_a = vals[ai]
        idle += deltas.get(t, 0)
        x_vals.append(cur_a + idle)
    return from_breakpoints(all_times, x_vals, trace.horizon)


def a0_cost(trace: BrickTrace, costs: CostModel) -> float:
    """Closed-form optimal cost from the LIFO matching.

    cost = P * busy + sum_matched min(P*gap, beta_on+beta_off)
         + beta_off * (#unmatched departures)   [forced by x(T)=a(T)]
         + beta_on  * (#unmatched arrivals)     [pre-t0 off servers popped]
    """
    total = costs.P * trace.busy_time()
    for dep, arr in trace.empty_periods():
        if arr is None:
            total += costs.beta_off
        else:
            total += min(costs.P * (arr - dep), costs.beta)
    total += costs.beta_on * trace.unmatched_arrivals()
    return total


# ---------------------------------------------------------------------------
# Literal Optimal Solution Construction Procedure
# ---------------------------------------------------------------------------

def optimal_schedule_constructed(trace: BrickTrace, costs: CostModel) -> StepFn:
    delta = costs.delta
    segs = critical_segments(trace)
    breaks: list[tuple[float, float]] = [(0.0, float(trace.initial_count()))]

    def set_piece(t0: float, t1: float, fn_breaks: list[tuple[float, float]]) -> None:
        breaks.extend(fn_breaks)

    a_times, a_vals = trace.a_breakpoints()

    def a_breaks_in(t0: float, t1: float) -> list[tuple[float, float]]:
        """Breakpoints of a(t) restricted to [t0, t1)."""
        out = [(t0, float(_a_at(a_times, a_vals, t0)))]
        for tt, vv in zip(a_times, a_vals):
            if t0 < tt < t1:
                out.append((tt, float(vv)))
        return out

    for seg in segs:
        t0, t1 = seg.start, seg.end
        if seg.seg_type in (SegmentType.TYPE_I, SegmentType.TYPE_II):
            set_piece(t0, t1, a_breaks_in(t0, t1))
        elif seg.seg_type == SegmentType.TYPE_III:
            if costs.beta >= costs.P * (t1 - t0):
                set_piece(t0, t1, [(t0, float(seg.start_level))])
            else:
                set_piece(t0, t1, a_breaks_in(t0, t1))
        else:  # TYPE_IV
            if costs.beta >= costs.P * (t1 - t0):
                set_piece(t0, t1, [(t0, float(seg.start_level))])
            else:
                pairs = _greedy_pairs(trace, t0, t1, delta)
                cursor = t0
                for dep, arr in pairs:
                    if dep > cursor:
                        set_piece(cursor, dep, a_breaks_in(cursor, dep))
                    # flat at the pre-departure level across [dep, arr)
                    lvl = float(_a_before(a_times, a_vals, dep))
                    set_piece(dep, arr, [(dep, lvl)])
                    cursor = arr
                if cursor < t1:
                    set_piece(cursor, t1, a_breaks_in(cursor, t1))
    # De-duplicate times keeping the last value written at each breakpoint
    # (segment boundaries are written by both neighbours).
    by_time: dict[float, float] = {}
    for t, v in breaks:
        by_time[t] = v
    ts = sorted(by_time)
    return from_breakpoints(ts, [by_time[t] for t in ts], trace.horizon)


def _greedy_pairs(
    trace: BrickTrace, t0: float, t1: float, delta: float
) -> list[tuple[float, float]]:
    """The (tau_l, tau_l') pairs of the Type-IV rule.

    Scan departures in [t0, t1] in time order; select the first whose LIFO
    matched arrival satisfies gap <= Delta; skip to after its arrival; repeat.
    """
    match = trace.lifo_matching()
    deps = sorted(
        (trace.events[i].time, arr)
        for i, arr in match.items()
        if arr is not None and t0 < trace.events[i].time and arr <= t1
    )
    pairs = []
    cursor = t0
    for dep, arr in deps:
        if dep < cursor:
            continue
        if arr - dep <= delta:
            pairs.append((dep, arr))
            cursor = arr
    return pairs


def _a_at(times: list[float], vals: list[int], t: float) -> int:
    v = vals[0]
    for tt, vv in zip(times, vals):
        if tt <= t:
            v = vv
        else:
            break
    return v


def _a_before(times: list[float], vals: list[int], t: float) -> int:
    v = vals[0]
    for tt, vv in zip(times, vals):
        if tt < t:
            v = vv
        else:
            break
    return v


def optimal_cost(trace: BrickTrace, costs: CostModel) -> float:
    """Optimal SCP cost (via the constructed schedule)."""
    x = optimal_schedule_constructed(trace, costs)
    return schedule_cost(x, costs, final_level=float(trace.final_count()))
