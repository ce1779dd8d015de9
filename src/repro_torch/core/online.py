"""Event-driven online simulator for the brick model (paper Section IV).

The simulator replays a :class:`BrickTrace` against:
  * the central last-empty-server-first dispatcher (a LIFO stack), and
  * a per-server ski-rental policy (A1/A2/A3/offline/...).

Because LIFO dispatch depends only on past arrivals/departures (Lemma 6), the
pop time of every pushed server equals its offline LIFO-matched arrival, which
the simulator precomputes; the *policy* never reads it except through the
permitted prediction window (the peek step).

A copy of ``repro.core.online`` (numpy and the stdlib only).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .costs import CostModel
from .events import ARRIVAL, BrickTrace
from .ski_rental import OfflinePolicy, SkiRentalPolicy
from .stepfn import StepFn, from_breakpoints

_TRACE_EVENT = 0   # processed before timers at equal times (measure-zero ties)
_TIMER = 1


@dataclasses.dataclass
class SimResult:
    cost: float
    energy: float
    toggle_cost: float
    n_on: StepFn                        # x(t): number of running servers
    assignments: list[tuple[int, int]]  # (job index, server id) in dispatch order
    n_turn_on: int
    n_turn_off: int


def simulate(
    trace: BrickTrace,
    policy: SkiRentalPolicy,
    costs: CostModel,
    rng: np.random.Generator | None = None,
    predicted_pop: dict[int, float | None] | None = None,
) -> SimResult:
    """Run the LIFO dispatcher + per-server policy over the trace.

    ``predicted_pop``: optional map departure-event-index -> predicted pop
    time, used by the peek step instead of the true pop (prediction-error
    experiments).  Defaults to the exact LIFO matching (accurate prediction).
    """
    rng = rng or np.random.default_rng(0)
    delta = costs.delta
    alpha = float(getattr(policy, "alpha", 0.0))
    offline = isinstance(policy, OfflinePolicy)

    match = trace.lifo_matching()            # dep event idx -> true pop time
    if predicted_pop is None:
        predicted_pop = match

    T = trace.horizon
    n0 = trace.initial_count()

    busy_job_to_server: dict[int, int] = {}
    next_fresh = n0
    stack: list[dict] = []   # LIFO of idle/off server entries
    energy = 0.0
    toggles_on = 0
    toggles_off = 0

    init_jobs = [i for i, j in enumerate(trace.jobs) if j.arrival <= 0]
    for sid, ji in enumerate(init_jobs):
        busy_job_to_server[ji] = sid
    assignments: list[tuple[int, int]] = [(ji, busy_job_to_server[ji]) for ji in init_jobs]

    x_breaks: list[tuple[float, int]] = [(0.0, n0)]
    state = {"x": n0}

    def record_x(t: float, dx: int) -> None:
        state["x"] += dx
        x_breaks.append((t, state["x"]))

    def decide(entry: dict, t: float) -> None:
        """The peek-and-decide moment for an idle server (policy's W elapsed)."""
        nonlocal energy, toggles_off
        pop = predicted_pop.get(entry["dep_idx"])
        will_pop = pop is not None and t < pop <= t + alpha * delta
        if not will_pop:
            energy += costs.P * (t - entry["since"])  # idle energy until now
            entry["state"] = "off"
            entry["since"] = t
            toggles_off += 1
            record_x(t, -1)
        # else: stay idle; energy accounted when popped (or at horizon)

    heap: list[tuple[float, int, int, tuple]] = []
    seq = 0
    for i, e in enumerate(trace.events):
        heapq.heappush(heap, (e.time, _TRACE_EVENT, seq, ("trace", i)))
        seq += 1

    def schedule_timer(t: float, entry: dict) -> None:
        nonlocal seq
        if t <= T:
            heapq.heappush(heap, (t, _TIMER, seq, ("timer", entry)))
            seq += 1
        # a timer beyond the horizon never fires; finalization handles it

    while heap:
        t, _, _, payload = heapq.heappop(heap)
        if payload[0] == "trace":
            e = trace.events[payload[1]]
            if e.kind == ARRIVAL:
                if stack:
                    entry = stack.pop()
                    sid = entry["sid"]
                    entry["cancelled"] = True
                    if entry["state"] == "idle":
                        energy += costs.P * (t - entry["since"])
                    else:  # off -> turn on
                        toggles_on += 1
                        record_x(t, +1)
                else:
                    sid = next_fresh
                    next_fresh += 1
                    toggles_on += 1
                    record_x(t, +1)
                busy_job_to_server[e.job] = sid
                assignments.append((e.job, sid))
            else:  # departure
                sid = busy_job_to_server.pop(e.job)
                entry = {
                    "sid": sid,
                    "dep_idx": payload[1],
                    "since": t,
                    "state": "idle",
                    "cancelled": False,
                }
                stack.append(entry)
                if offline:
                    pop = match.get(payload[1])
                    if not (pop is not None and (pop - t) <= delta):
                        entry["state"] = "off"
                        toggles_off += 1
                        record_x(t, -1)
                else:
                    w = policy.wait_time(delta, rng)
                    if w <= 0.0:
                        decide(entry, t)
                    else:
                        schedule_timer(t + w, entry)
        else:  # timer
            entry = payload[1]
            if entry["cancelled"] or entry["state"] != "idle":
                continue
            decide(entry, t)

    # Finalize: idle servers at the horizon are forced off by x(T) = a(T).
    for entry in stack:
        if not entry["cancelled"] and entry["state"] == "idle":
            energy += costs.P * (T - entry["since"])
            toggles_off += 1
            record_x(T, -1)

    energy += costs.P * trace.busy_time()

    toggle_cost = costs.beta_on * toggles_on + costs.beta_off * toggles_off
    by_time: dict[float, int] = {}
    for tt, vv in x_breaks:
        by_time[tt] = vv
    ts = sorted(by_time)
    x = from_breakpoints(ts, [float(by_time[tt]) for tt in ts], T)
    return SimResult(
        cost=energy + toggle_cost,
        energy=energy,
        toggle_cost=toggle_cost,
        n_on=x,
        assignments=assignments,
        n_turn_on=toggles_on,
        n_turn_off=toggles_off,
    )
