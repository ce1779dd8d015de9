"""Continuous-time "brick" workload model (paper Section II-A).

Jobs are "elephants": each occupies one full server for its entire sojourn.
``a(t)`` is the number of concurrent jobs; it changes by +/-1 at arrival /
departure epochs and no two epochs coincide.

The central combinatorial object is the *LIFO matching* between departures and
arrivals induced by the paper's last-empty-server-first dispatching: when a job
departs, its server is pushed on a stack; an arrival pops the most recently
pushed server.  A departure at time ``tau`` is therefore matched to the first
arrival ``tau' > tau`` with ``a(tau'^-) + 1 == a(tau^-)`` and
``a(t) < a(tau^-)`` for all ``t`` in ``(tau, tau')`` — the parenthesis
structure used throughout Section III/IV of the paper.

A copy of ``repro.core.events`` (numpy and the stdlib only).
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Iterable, Sequence

import numpy as np

ARRIVAL = 1
DEPARTURE = -1


@dataclasses.dataclass(frozen=True)
class Job:
    """One elephant job: occupies one server on [arrival, departure)."""

    arrival: float
    departure: float

    def __post_init__(self) -> None:
        if not self.departure > self.arrival:
            raise ValueError(f"job must have departure > arrival, got {self}")


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    kind: int  # ARRIVAL or DEPARTURE
    job: int   # index into the trace's job list


class BrickTrace:
    """A finite set of jobs on a horizon [0, T] with distinct event epochs."""

    def __init__(self, jobs: Sequence[Job], horizon: float):
        self.jobs = list(jobs)
        self.horizon = float(horizon)
        for j in self.jobs:
            if j.arrival < 0 or j.departure > self.horizon:
                raise ValueError(f"job {j} outside horizon [0, {self.horizon}]")
        events = []
        for idx, j in enumerate(self.jobs):
            if j.arrival > 0:
                events.append(Event(j.arrival, ARRIVAL, idx))
            if j.departure < self.horizon:
                events.append(Event(j.departure, DEPARTURE, idx))
        events.sort(key=lambda e: e.time)
        times = [e.time for e in events]
        if len(set(times)) != len(times):
            raise ValueError("simultaneous events are not allowed (paper assumption)")
        self.events: list[Event] = events
        self._times = times

    # ----- workload step function a(t) (right-continuous) -----
    def initial_count(self) -> int:
        return sum(1 for j in self.jobs if j.arrival <= 0)

    def a_breakpoints(self) -> tuple[list[float], list[int]]:
        """Breakpoint times (starting at 0) and right-continuous values of a(t)."""
        times = [0.0]
        vals = [self.initial_count()]
        for e in self.events:
            times.append(e.time)
            vals.append(vals[-1] + (1 if e.kind == ARRIVAL else -1))
        return times, vals

    def a_at(self, t: float) -> int:
        """Right-continuous a(t)."""
        times, vals = self.a_breakpoints()
        i = bisect.bisect_right(times, t) - 1
        return vals[max(i, 0)]

    def a_before(self, t: float) -> int:
        """Left limit a(t^-)."""
        times, vals = self.a_breakpoints()
        i = bisect.bisect_left(times, t) - 1
        return vals[max(i, 0)]

    def final_count(self) -> int:
        times, vals = self.a_breakpoints()
        return vals[-1]

    # ----- LIFO matching -----
    def lifo_matching(self) -> dict[int, float | None]:
        """Map departure-event index -> matched arrival time (or None).

        Mirrors the last-empty-server-first stack: a departure pushes, an
        arrival pops the most recent unmatched departure.  Arrivals with an
        empty stack pop a server that was off before t=0 (unmatched arrival).
        """
        match: dict[int, float | None] = {}
        stack: list[int] = []  # indices into self.events of unmatched departures
        for i, e in enumerate(self.events):
            if e.kind == DEPARTURE:
                stack.append(i)
                match[i] = None
            else:
                if stack:
                    match[stack.pop()] = e.time
        return match

    def empty_periods(self) -> list[tuple[float, float | None]]:
        """(departure time, matched arrival time or None) per departure event."""
        m = self.lifo_matching()
        return [(self.events[i].time, m[i]) for i in sorted(m)]

    def unmatched_arrivals(self) -> int:
        """Arrivals that pop a pre-t0 off server (incur beta_on)."""
        stack = 0
        unmatched = 0
        for e in self.events:
            if e.kind == DEPARTURE:
                stack += 1
            else:
                if stack:
                    stack -= 1
                else:
                    unmatched += 1
        return unmatched

    def busy_time(self) -> float:
        """Total server-busy time inside the horizon."""
        return sum(
            min(j.departure, self.horizon) - max(j.arrival, 0.0) for j in self.jobs
        )

    def max_concurrency(self) -> int:
        _, vals = self.a_breakpoints()
        return max(vals) if vals else 0


# --------------------------------------------------------------------------
# Generators
# --------------------------------------------------------------------------

def generate_brick_trace(
    rng: np.random.Generator,
    horizon: float = 200.0,
    rate: float = 1.0,
    mean_duration: float = 4.0,
    diurnal: bool = True,
    max_jobs: int = 100_000,
) -> BrickTrace:
    """Poisson-ish arrivals with time-varying rate and exponential sojourns.

    Event times are de-duplicated by tiny jitter so no two epochs coincide.
    """
    jobs: list[Job] = []
    t = 0.0
    while t < horizon and len(jobs) < max_jobs:
        lam = rate
        if diurnal:
            lam = rate * (1.0 + 0.8 * math.sin(2 * math.pi * t / max(horizon / 3.0, 1e-9)))
            lam = max(lam, 0.05 * rate)
        t += rng.exponential(1.0 / lam)
        if t >= horizon:
            break
        dur = rng.exponential(mean_duration)
        dep = min(t + max(dur, 1e-6), horizon - 1e-9)
        if dep > t:
            jobs.append(Job(t, dep))
    return _deduplicate(jobs, horizon, rng)


def _deduplicate(jobs: Iterable[Job], horizon: float, rng: np.random.Generator) -> BrickTrace:
    """Jitter event epochs until all are distinct (paper's no-tie assumption)."""
    jobs = list(jobs)
    for _ in range(100):
        times = []
        for j in jobs:
            times.extend((j.arrival, j.departure))
        if len(set(times)) == len(times):
            break
        seen: set[float] = set()
        fixed: list[Job] = []
        for j in jobs:
            a, d = j.arrival, j.departure
            while a in seen:
                a += float(rng.uniform(1e-7, 1e-5))
            seen.add(a)
            while d in seen or d <= a:
                d += float(rng.uniform(1e-7, 1e-5))
            seen.add(d)
            fixed.append(Job(min(a, horizon - 1e-9), min(max(d, a + 1e-9), horizon)))
        jobs = fixed
    return BrickTrace(jobs, horizon)


def trace_from_intervals(intervals: Sequence[tuple[float, float]], horizon: float) -> BrickTrace:
    """Build a trace from explicit (arrival, departure) pairs (for tests)."""
    return BrickTrace([Job(a, d) for a, d in intervals], horizon)
