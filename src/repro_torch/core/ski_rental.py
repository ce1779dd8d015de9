"""Future-aware ski-rental policies (paper Section IV).

Each policy answers a single question for a just-emptied server: *how long do
I stay idle before (peeking into the prediction window and possibly) turning
off?*  The prediction window has size ``alpha * Delta``; with the
last-empty-server-first dispatch a server can tell from predicted workload
whether it will be popped during the window (Section IV-B).

Policies return a wait time ``W``; the simulator then peeks: if the server's
next pop is within ``(t_dep + W, t_dep + W + alpha*Delta]`` it stays idle,
otherwise it turns off.

NOTE on A3's distribution: the paper's stated ``P(Z=0) = 1 - alpha/(e-1+alpha)``
does not normalize against its own density (whose total mass is
``1 - alpha/(e-1+alpha)``).  We use the corrected atom
``P(Z=0) = alpha/(e-1+alpha)``; tests verify the resulting empirical
competitive ratio is within the claimed ``e/(e-1+alpha)``.

A copy of ``repro.core.ski_rental`` (numpy only); the eval harness takes
the paper's bounds from :func:`theoretical_ratio`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Protocol

import numpy as np

E = math.e


class SkiRentalPolicy(Protocol):
    alpha: float

    def wait_time(self, delta: float, rng: np.random.Generator) -> float:
        """Idle duration before the (single) peek-and-decide moment."""
        ...


@dataclasses.dataclass(frozen=True)
class OfflinePolicy:
    """Hindsight-optimal: handled specially by the simulator (gap vs Delta)."""

    alpha: float = 1.0

    def wait_time(self, delta: float, rng: np.random.Generator) -> float:  # pragma: no cover
        return 0.0


@dataclasses.dataclass(frozen=True)
class A1Deterministic:
    """Algorithm A1: wait (1-alpha)*Delta, then peek. Ratio 2 - alpha."""

    alpha: float = 0.0

    def wait_time(self, delta: float, rng: np.random.Generator) -> float:
        return (1.0 - self.alpha) * delta

    def competitive_ratio(self) -> float:
        return 2.0 - self.alpha


@dataclasses.dataclass(frozen=True)
class A2Randomized:
    """Algorithm A2: Z ~ e^{z/((1-a)D)} / ((e-1)(1-a)D) on [0,(1-a)D].

    Ratio (e - alpha) / (e - 1).
    """

    alpha: float = 0.0

    def wait_time(self, delta: float, rng: np.random.Generator) -> float:
        span = (1.0 - self.alpha) * delta
        if span <= 0.0:
            return 0.0
        u = rng.uniform()
        return span * math.log1p(u * (E - 1.0))

    def competitive_ratio(self) -> float:
        return (E - self.alpha) / (E - 1.0)


@dataclasses.dataclass(frozen=True)
class A3Randomized:
    """Algorithm A3: atom at 0 w.p. alpha/(e-1+alpha), else A2's density.

    Ratio e / (e - 1 + alpha) — optimal randomized under LIFO dispatch.
    """

    alpha: float = 0.0

    def wait_time(self, delta: float, rng: np.random.Generator) -> float:
        p0 = self.alpha / (E - 1.0 + self.alpha)
        if rng.uniform() < p0:
            return 0.0
        span = (1.0 - self.alpha) * delta
        if span <= 0.0:
            return 0.0
        u = rng.uniform()
        return span * math.log1p(u * (E - 1.0))

    def competitive_ratio(self) -> float:
        return E / (E - 1.0 + self.alpha)


@dataclasses.dataclass(frozen=True)
class BreakEven:
    """Classic break-even (no future info): wait Delta then turn off. Ratio 2.

    Identical to A1 with alpha = 0 (special case noted in Section IV-A).
    """

    alpha: float = 0.0

    def wait_time(self, delta: float, rng: np.random.Generator) -> float:
        return delta


@dataclasses.dataclass(frozen=True)
class DelayedOffPolicy:
    """DELAYEDOFF's per-server timer (t_wait = Delta by default); no peek."""

    alpha: float = 0.0  # never uses future info
    t_wait_factor: float = 1.0

    def wait_time(self, delta: float, rng: np.random.Generator) -> float:
        return self.t_wait_factor * delta


def theoretical_ratio(name: str, alpha: float) -> float:
    if name == "A1":
        return 2.0 - alpha
    if name == "A2":
        return (E - alpha) / (E - 1.0)
    if name == "A3":
        return E / (E - 1.0 + alpha)
    raise KeyError(name)
