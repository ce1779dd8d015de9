"""Serving request/session generators.

Sessions are the paper's "elephant" jobs: a session occupies one replica slot
for its entire lifetime (its KV cache pins it — no migration).  The generator
produces a BrickTrace-compatible session stream whose concurrency profile
follows a fluid trace (e.g. the MSR-like weekly workload), so the paper's
experiments drive the serving cluster directly.

A copy of ``repro.data.requests`` (numpy only).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.events import BrickTrace, Job
from ..core.traces import brick_trace_from_fluid, msr_like_trace


@dataclasses.dataclass
class Session:
    session_id: int
    arrival: float
    departure: float          # known only to the simulator, not the policy
    prompt_tokens: int = 64
    max_new_tokens: int = 128


@dataclasses.dataclass
class SessionTrace:
    sessions: list[Session]
    horizon: float

    def to_brick(self) -> BrickTrace:
        return BrickTrace(
            [Job(s.arrival, s.departure) for s in self.sessions], self.horizon
        )


def generate_sessions(
    rng: np.random.Generator,
    n_slots: int = 200,
    mean_concurrency: float = 8.0,
    prompt_tokens: int = 64,
    max_new_tokens: int = 128,
) -> SessionTrace:
    """Session stream whose concurrency follows an MSR-like fluid trace."""
    a = msr_like_trace(rng, n_slots=n_slots, mean_jobs=mean_concurrency)
    brick = brick_trace_from_fluid(a, rng)
    sessions = [
        Session(
            session_id=i,
            arrival=j.arrival,
            departure=j.departure,
            prompt_tokens=int(rng.integers(prompt_tokens // 2, prompt_tokens * 2)),
            max_new_tokens=int(rng.integers(max_new_tokens // 2, max_new_tokens * 2)),
        )
        for i, j in enumerate(brick.jobs)
    ]
    return SessionTrace(sessions=sessions, horizon=brick.horizon)
