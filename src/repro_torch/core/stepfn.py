"""Piecewise-constant, right-continuous step functions on [0, T].

A copy of ``repro.core.stepfn`` (stdlib only), used by
:func:`repro_torch.core.costs.schedule_cost`.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Sequence


@dataclasses.dataclass
class StepFn:
    """Right-continuous step function: value ``values[i]`` on [times[i], times[i+1])."""

    times: list[float]   # strictly increasing, times[0] == 0
    values: list[float]
    horizon: float

    def __post_init__(self) -> None:
        assert self.times and self.times[0] == 0.0
        assert len(self.times) == len(self.values)
        for u, v in zip(self.times[:-1], self.times[1:]):
            assert v > u, f"times must be strictly increasing, got {u} -> {v}"

    def at(self, t: float) -> float:
        i = bisect.bisect_right(self.times, t) - 1
        return self.values[max(i, 0)]

    def before(self, t: float) -> float:
        i = bisect.bisect_left(self.times, t) - 1
        return self.values[max(i, 0)]

    def integral(self) -> float:
        total = 0.0
        for i, v in enumerate(self.values):
            t0 = self.times[i]
            t1 = self.times[i + 1] if i + 1 < len(self.times) else self.horizon
            total += v * (t1 - t0)
        return total

    def switching(self) -> tuple[float, float]:
        """(total up-moves, total down-moves) across breakpoints."""
        up = down = 0.0
        for u, v in zip(self.values[:-1], self.values[1:]):
            if v > u:
                up += v - u
            else:
                down += u - v
        return up, down

    def simplified(self) -> "StepFn":
        """Merge consecutive intervals with equal values."""
        ts, vs = [self.times[0]], [self.values[0]]
        for t, v in zip(self.times[1:], self.values[1:]):
            if v != vs[-1]:
                ts.append(t)
                vs.append(v)
        return StepFn(ts, vs, self.horizon)

    def equals(self, other: "StepFn", tol: float = 0.0) -> bool:
        a, b = self.simplified(), other.simplified()
        if len(a.times) != len(b.times):
            return False
        return all(
            abs(ta - tb) <= tol and va == vb
            for ta, tb, va, vb in zip(a.times, b.times, a.values, b.values)
        )


def from_breakpoints(times: Sequence[float], values: Sequence[float], horizon: float) -> StepFn:
    return StepFn(list(times), list(values), horizon).simplified()


def pointwise_max(f: StepFn, g: StepFn) -> StepFn:
    times = sorted(set(f.times) | set(g.times))
    vals = [max(f.at(t), g.at(t)) for t in times]
    return StepFn(times, vals, f.horizon).simplified()


def build(horizon: float, breaks: Sequence[tuple[float, float]]) -> StepFn:
    """breaks: (time, new value) pairs; first must be (0, v0)."""
    ts = [b[0] for b in breaks]
    vs = [b[1] for b in breaks]
    return StepFn(ts, vs, horizon).simplified()


def map_values(f: StepFn, fn: Callable[[float], float]) -> StepFn:
    return StepFn(list(f.times), [fn(v) for v in f.values], f.horizon).simplified()
