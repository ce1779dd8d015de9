"""Critical times / critical segments (paper Section III-A, Proposition 1).

Implements the paper's Critical Segment Construction Procedure on a
:class:`~repro_torch.core.events.BrickTrace` and classifies every segment as one of
the four workload types:

  Type-I   non-decreasing
  Type-II  step-decreasing (drops by one at the left end, never recovers)
  Type-III U-shape (drops by one, flat, recovers exactly at the right end)
  Type-IV  canyon-shape (drops, wanders strictly below, recovers at right end)

A copy of ``repro.core.segments`` (the stdlib only).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

from .events import ARRIVAL, DEPARTURE, BrickTrace


class SegmentType(enum.Enum):
    TYPE_I = "I"
    TYPE_II = "II"
    TYPE_III = "III"
    TYPE_IV = "IV"


@dataclasses.dataclass(frozen=True)
class CriticalSegment:
    start: float
    end: float
    start_level: int          # a at the segment start (left limit for departures)
    end_level: int
    seg_type: SegmentType


def critical_times(trace: BrickTrace) -> list[float]:
    """The paper's Critical Segment Construction Procedure.

    T_1 = 0 (treated as an arrival epoch when no event occurs there).  Then
    inductively:
      * from an arrival epoch, the next critical time is the first departure;
      * from a departure epoch with pre-departure level L, the next critical
        time is the first later arrival that returns a(.) to L; if none
        exists, the next departure epoch; if neither exists, the horizon T.
    """
    events = trace.events
    T = trace.horizon

    # Prefix values: a right after event i.
    a0 = trace.initial_count()
    after = []
    cur = a0
    for e in events:
        cur += 1 if e.kind == ARRIVAL else -1
        after.append(cur)

    def a_after_index(i: int) -> int:
        return after[i] if i >= 0 else a0

    crits = [0.0]
    # Determine the kind of the current critical time.
    if events and events[0].time == 0.0:
        kind = events[0].kind
        idx = 0
    else:
        kind = ARRIVAL  # "if no job departs or arrives at T_1, it is an arrival epoch"
        idx = -1        # index of the event at the current critical time (-1: none)

    while True:
        if kind == ARRIVAL:
            # next critical time: first departure epoch after current
            nxt = None
            for j in range(idx + 1, len(events)):
                if events[j].kind == DEPARTURE:
                    nxt = j
                    break
            if nxt is None:
                if crits[-1] < T:
                    crits.append(T)
                break
            crits.append(events[nxt].time)
            idx, kind = nxt, DEPARTURE
        else:
            # departure epoch: level before this departure
            level_before = a_after_index(idx - 1) if idx >= 0 else a0
            # first arrival tau after idx with a(tau) == level_before
            nxt = None
            for j in range(idx + 1, len(events)):
                if events[j].kind == ARRIVAL and after[j] == level_before:
                    nxt = j
                    break
            if nxt is not None:
                crits.append(events[nxt].time)
                idx, kind = nxt, ARRIVAL
                continue
            # otherwise: next departure epoch
            nxt = None
            for j in range(idx + 1, len(events)):
                if events[j].kind == DEPARTURE:
                    nxt = j
                    break
            if nxt is None:
                if crits[-1] < T:
                    crits.append(T)
                break
            crits.append(events[nxt].time)
            idx, kind = nxt, DEPARTURE
    return crits


def classify_segment(trace: BrickTrace, t0: float, t1: float) -> SegmentType:
    """Classify workload on [t0, t1] per Proposition 1."""
    # Values strictly inside the segment plus boundary limits.
    lvl0 = trace.a_before(t0) if _is_departure_at(trace, t0) else trace.a_at(t0)
    lvl1 = trace.a_at(t1)
    interior = _interior_values(trace, t0, t1)
    if not _is_departure_at(trace, t0):
        return SegmentType.TYPE_I
    # t0 is a departure: level drops to lvl0 - 1 right after t0.
    if lvl1 == lvl0:
        if all(v == lvl0 - 1 for v in interior):
            return SegmentType.TYPE_III
        return SegmentType.TYPE_IV
    return SegmentType.TYPE_II


def critical_segments(trace: BrickTrace) -> list[CriticalSegment]:
    crits = critical_times(trace)
    segs = []
    for t0, t1 in zip(crits[:-1], crits[1:]):
        st = classify_segment(trace, t0, t1)
        lvl0 = trace.a_before(t0) if _is_departure_at(trace, t0) else trace.a_at(t0)
        segs.append(CriticalSegment(t0, t1, lvl0, trace.a_at(t1), st))
    return segs


def _is_departure_at(trace: BrickTrace, t: float) -> bool:
    return any(e.time == t and e.kind == DEPARTURE for e in trace.events)


def _interior_values(trace: BrickTrace, t0: float, t1: float) -> Sequence[int]:
    times, vals = trace.a_breakpoints()
    out = []
    for tt, vv in zip(times, vals):
        if t0 < tt < t1:
            out.append(vv)
    # Also the value right after t0 (constant until the first interior event).
    out.insert(0, trace.a_at(t0))
    return out
